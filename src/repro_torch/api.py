"""Request/response façade for DOSA co-search (single target).

The PyTorch port of `repro.api`: `dosa_search(workload, cfg)` builds a
`SearchRequest` and calls `run_request`, which dispatches to
`core.search.execute_search` on the request's device (``"cuda"``
unless the caller asks for the CPU).  Portfolio (fleet) requests and
the serving layer's scheduling hints are not ported yet (ROADMAP queue
1: "Fleet"; "Serving, runtime, checkpoint and telemetry").
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from .core.problem import Workload
# SearchResult is re-exported: it is the concrete result users get.
from .core.search import SearchConfig, SearchResult  # noqa: F401
from .device import DEFAULT_DEVICE


@dataclasses.dataclass
class SearchRequest:
    """One single-target co-search query: (workload, config, engine).

    `population`/`fused` select the engine exactly as in the reference;
    `device` names where it runs.  `specs` (a portfolio fleet request)
    raises until the fleet slice is ported.  `request_id` defaults to a
    deterministic fingerprint of the query."""
    workload: Workload
    config: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    specs: tuple | None = None
    population: int | None = None
    fused: bool = True
    device: str = DEFAULT_DEVICE
    request_id: str | None = None

    def __post_init__(self):
        if self.specs is not None:
            raise NotImplementedError(
                "fleet (portfolio) requests are not ported yet (ROADMAP "
                "queue 1: Fleet)")
        if not isinstance(self.workload, Workload):
            raise ValueError("single-target requests take one Workload")
        if self.request_id is None:
            self.request_id = self.fingerprint()

    def fingerprint(self) -> str:
        """Deterministic identity of the query — stable across
        processes and independent of the device it runs on."""
        payload = {
            "workloads": [_workload_repr(self.workload)],
            "specs": None,
            "config": _config_repr(self.config),
            "population": self.population,
            "fused": bool(self.fused),
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass
class SearchOutcome:
    """The response: who asked and what was found.  (The reference's
    serving statuses come with the serving slice.)"""
    request_id: str
    result: SearchResult | None

    @property
    def best_edp(self) -> float:
        return self.result.best_edp if self.result is not None \
            else float("inf")

    @property
    def history(self) -> list[tuple[int, float]]:
        return self.result.history if self.result is not None else []

    @property
    def n_evals(self) -> int:
        return self.result.n_evals if self.result is not None else 0


def _workload_repr(w: Workload) -> list:
    return [w.name] + [[lay.name, list(lay.dims), lay.wstride,
                        lay.hstride, lay.repeat] for lay in w.layers]


def _config_repr(cfg: SearchConfig) -> dict:
    rep = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "spec":
            rep[f.name] = None if v is None else v.name
        elif f.name in ("latency_model", "surrogate"):
            rep[f.name] = None if v is None else repr(type(v)) + str(id(v))
        elif f.name == "fixed_hw":
            rep[f.name] = None if v is None else repr(v)
        else:
            rep[f.name] = v
    return rep


def run_request(req: SearchRequest) -> SearchOutcome:
    """Execute one request synchronously on the calling thread, on the
    request's device."""
    from .core.search import execute_search

    result = execute_search(req.workload, req.config,
                            population=req.population, fused=req.fused,
                            device=req.device)
    return SearchOutcome(request_id=req.request_id, result=result)
