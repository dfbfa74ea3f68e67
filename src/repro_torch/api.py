"""Unified request/response façade for DOSA co-search.

The PyTorch port of `repro.api`.  One request type for every way of
asking the engine a question:

* single-target synchronous — `dosa_search(workload, cfg)` builds a
  `SearchRequest(workload=..., config=...)` and calls `run_request`;
* portfolio synchronous — `fleet_search(...)` sets `specs=(...)`;
* streamed / batched — `serve.cosearch_service.CoSearchService.submit`
  takes the same `SearchRequest` objects and multiplexes them onto
  warm shared engines.

`run_request` is a thin dispatcher: all search semantics live in
`core.search.execute_search` / `core.fleet.execute_fleet_search`, run on
the request's `device` (``"cuda"`` unless the caller asks for the CPU).
Both `SearchResult` and `FleetResult` satisfy the `ResultLike` protocol
(`best_edp`, `history`, `n_evals`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Protocol, runtime_checkable

from .core.archspec import ArchSpec
from .core.problem import Workload
# SearchResult is re-exported: it is the concrete ResultLike users get.
from .core.search import SearchConfig, SearchResult  # noqa: F401
from .device import DEFAULT_DEVICE


@runtime_checkable
class ResultLike(Protocol):
    """Shared result protocol: every search outcome, single-target or
    fleet, answers these three questions the same way."""

    @property
    def best_edp(self) -> float: ...

    @property
    def history(self) -> list[tuple[int, float]]: ...

    @property
    def n_evals(self) -> int: ...


@dataclasses.dataclass
class SearchRequest:
    """One co-search query: (workload(s), target(s), budget).

    `specs=None` asks a single-target search against `config.spec`
    (None meaning the default Gemmini target); `specs=(...)` asks a
    portfolio fleet search over those targets.  `population`/`fused`
    select the execution engine exactly as the legacy entry points did.
    `request_id` identifies the query through the serving layer's
    streaming responses and checkpoints; it defaults to a deterministic
    fingerprint of the request so retried submissions resume the same
    checkpointed task.

    `priority`, `deadline_s` and `segment_budget` are *scheduling
    hints* for the serving layer (weighted round-robin share, wall-clock
    timeout, max rounding segments before a partial-result timeout).
    They are deliberately excluded from the fingerprint: the same query
    resubmitted at a different priority must dedup onto the same
    in-flight task.  `device` names where the search runs: a device, or
    a sequence of devices over which the fused engine shards its
    population (``config.shards``).  It is not part of the fingerprint
    either (the answer does not depend on it), but the serving layer
    batches only requests on one device tuple.
    """
    workload: Workload | Iterable[Workload]
    config: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    specs: tuple[ArchSpec, ...] | None = None   # portfolio targets
    population: int | None = None               # engine population size
    fused: bool = True
    request_id: str | None = None
    priority: int = 0                  # serving: higher = larger share
    deadline_s: float | None = None    # serving: wall-clock budget
    segment_budget: int | None = None  # serving: max rounding segments
    device: str | tuple = DEFAULT_DEVICE  # where the search runs

    def __post_init__(self):
        if isinstance(self.device, list):
            self.device = tuple(self.device)
        if self.specs is not None:
            self.specs = tuple(self.specs)
            if not self.specs:
                raise ValueError("specs=() asks a fleet search over no "
                                 "targets; pass specs=None for a "
                                 "single-target search")
            if self.population is not None:
                raise ValueError("population applies to single-target "
                                 "requests; fleet requests size their "
                                 "populations from config.n_start_points")
        if self.specs is None and not isinstance(self.workload, Workload):
            raise ValueError("single-target requests take one Workload; "
                             "pass specs=(...) for a portfolio request")
        if not isinstance(self.priority, int):
            raise ValueError(f"priority must be an int, "
                             f"got {self.priority!r}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0 or None, "
                             f"got {self.deadline_s!r}")
        if self.segment_budget is not None and (
                not isinstance(self.segment_budget, int)
                or self.segment_budget < 1):
            raise ValueError(f"segment_budget must be a positive int or "
                             f"None, got {self.segment_budget!r}")
        if self.request_id is None:
            self.request_id = self.fingerprint()

    @property
    def is_fleet(self) -> bool:
        return self.specs is not None

    def fingerprint(self) -> str:
        """Deterministic identity of the query — stable across
        processes, so a resubmitted request finds its checkpoints."""
        wls = ([self.workload] if isinstance(self.workload, Workload)
               else list(self.workload))
        if not isinstance(self.workload, Workload):
            # Freeze generator-style iterables so later consumers see
            # the same portfolio the fingerprint hashed.
            self.workload = wls
        payload = {
            "workloads": [_workload_repr(w) for w in wls],
            "specs": (None if self.specs is None
                      else [s.name for s in self.specs]),
            "config": _config_repr(self.config),
            "population": self.population,
            "fused": bool(self.fused),
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass
class SearchOutcome:
    """The response half of the API: who asked, what was found — and
    under what health.

    `status` is the structured serving verdict:

    * ``"ok"`` — completed normally; `result` is the full answer.
    * ``"degraded"`` — completed, but through a fallback path
      (`degraded` names each mode, e.g. ``surrogate_fallback`` when the
      learned latency model failed and the analytical model answered,
      or ``shard_fallback`` after a multi-device shard loss).
    * ``"timeout"`` — the request's deadline/segment budget expired;
      `result` is the best-so-far *partial* answer, `error` says which
      budget ran out.
    * ``"error"`` — quarantined poison input or exhausted retries;
      `result` is None and `error` carries the structured fault record
      (`runtime.faults.fault_record`).
    """
    request_id: str
    result: ResultLike | None
    status: str = "ok"
    error: dict | None = None
    degraded: tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "degraded")

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
            # Callables/models have no stable serialization; hash their
            # presence + identity so distinct models get distinct ids.
            rep[f.name] = None if v is None else repr(type(v)) + str(id(v))
        elif f.name == "fixed_hw":
            rep[f.name] = None if v is None else repr(v)
        else:
            rep[f.name] = v
    return rep


def run_request(req: SearchRequest) -> SearchOutcome:
    """Execute one request synchronously on the calling thread.

    Dispatches to the drivers on the request's device — a façade-built
    call is bit-identical to the equivalent direct `execute_search` /
    `execute_fleet_search` call.
    """
    from .core.fleet import execute_fleet_search
    from .core.search import execute_search

    if req.is_fleet:
        result = execute_fleet_search(req.workload, list(req.specs),
                                      req.config, fused=req.fused,
                                      device=req.device)
    else:
        result = execute_search(req.workload, req.config,
                                population=req.population, fused=req.fused,
                                device=req.device)
    return SearchOutcome(request_id=req.request_id, result=result)
