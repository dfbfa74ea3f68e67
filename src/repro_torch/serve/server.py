"""HTTP/JSON transport front-end for the co-search service.

The PyTorch port of `repro.serve.server`: the same endpoints, payload
whitelist and 400 messages.  The server takes its `device` at
construction (``"cuda"`` by default, and it raises there without a
GPU); every request it accepts runs on that device, and the payload
whitelist has no device field, so a client cannot move a search
elsewhere.  HTTP threads parse JSON and enqueue; only the scheduler
thread runs searches, so only it touches tensors.  A request that
needs a feature the port has not taken yet gets a 400 when it is
submitted.

`CoSearchServer` puts `serve.cosearch_service.CoSearchService` behind a
network boundary using only the standard library: a
`ThreadingHTTPServer` accepts requests concurrently, every touch of the
cooperative core is serialized under one lock, and a single scheduler
thread drives `service.step(contain_fatal=True)` whenever work is
pending — so the core stays effectively single-threaded (its
contract) while the transport is concurrent, and a task that exhausts
its retry budget becomes a structured ``error`` outcome instead of a
dead server thread.

Endpoints (all JSON):

* ``POST /v1/search`` — submit one search.  The boundary validates the
  payload *before* it reaches the engine: unknown fields are rejected,
  the workload is rebuilt through `core.problem.Layer` (which checks
  dims), the config is rebuilt through `SearchConfig.__post_init__`,
  and named specs resolve through `compile_spec`, which runs the full
  spec lint — so a malformed query gets a 400 with rule IDs, never a
  shape error inside the engine.  Replies 202
  ``{"request_id", "deduplicated"}`` (fingerprint-identical
  resubmissions attach to the in-flight task).
* ``GET /v1/result/<request_id>`` — 200 with the structured outcome
  (``status`` ok/degraded/timeout/error, best EDP, history, fault
  record) when done; 202 ``{"status": "pending"}`` while in flight;
  404 for an unknown id.
* ``GET /v1/events/<request_id>`` — the streamed per-segment progress.
* ``GET /v1/frontier`` — the service-wide Pareto frontier.
* ``GET /v1/stats`` — engine-cache / batching / fault counters.
* ``GET /v1/metrics`` — Prometheus text exposition (the one non-JSON
  endpoint): request/fault/segment families from the service registry
  merged with engine-build and checkpoint families from the
  process-global one.
* ``GET /v1/trace/<request_id>`` — the request's span tree (submit →
  queue wait → batch join → per-segment advances → drain, with fault
  events inline); 404 for unknown ids.
* ``GET /v1/healthz`` — liveness.

Request payload::

    {"workload": {"name": "net",
                  "layers": [{"matmul": [64, 64, 64]} |
                             {"conv": [Cin, Cout, kernel, out_hw]} |
                             {"dims": [R,S,P,Q,C,K,N], "wstride": 1,
                              "hstride": 1, "repeat": 1, "name": "l0"}]},
     "config": {"steps": 40, "seed": 3, "spec": "tpu_v5e", ...},
     "priority": 0, "deadline_s": null, "segment_budget": null,
     "request_id": null}

Tests drive a live server end-to-end with `urllib` — submission,
polling, dedup, malformed-payload rejection.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..api import SearchRequest
from ..core.archspec import (EDGE_SPEC, GEMMINI_SPEC, TPU_V5E_SPEC,
                             ArchSpec)
from ..core.problem import Layer, Workload
from ..core.search import SearchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from .cosearch_service import CoSearchService, ServiceConfig

# Named targets a transport payload may ask for.  Resolution compiles
# the spec, which runs the full SP5xx spec lint.
SPEC_REGISTRY: dict[str, ArchSpec] = {
    s.name: s for s in (GEMMINI_SPEC, TPU_V5E_SPEC, EDGE_SPEC)}

# Config fields a payload may set, with the scalar type the boundary
# coerces/validates.  Everything else in SearchConfig (specs as
# objects, callables, trained surrogates) has no JSON form and is
# rejected — semantic validation then happens in
# SearchConfig.__post_init__ exactly as for in-process callers.
_CONFIG_FIELDS: dict[str, type] = {
    "steps": int, "round_every": int, "n_start_points": int,
    "lr": float, "penalty_weight": float, "ordering_mode": str,
    "softmax_temp": float, "reject_factor": float,
    "max_reject_tries": int, "seed": int, "shards": int,
    "fix_pe_only": bool, "start_points": str,
}
_REQUEST_FIELDS = ("workload", "config", "priority", "deadline_s",
                   "segment_budget", "request_id")


def _type_name(v) -> str:
    return type(v).__name__


def _parse_layer(obj, idx: int) -> Layer:
    if not isinstance(obj, dict):
        raise ValueError(f"layers[{idx}] must be an object, "
                         f"got {_type_name(obj)}")
    if "matmul" in obj:
        m, k, n = (int(x) for x in obj["matmul"])
        return Layer.matmul(m, n, k, repeat=int(obj.get("repeat", 1)),
                            name=str(obj.get("name", f"matmul{idx}")))
    if "conv" in obj:
        c_in, c_out, kernel, out_hw = (int(x) for x in obj["conv"])
        return Layer.conv(c_in, c_out, kernel, out_hw,
                          stride=int(obj.get("stride", 1)),
                          repeat=int(obj.get("repeat", 1)),
                          name=str(obj.get("name", f"conv{idx}")))
    if "dims" not in obj:
        raise ValueError(f"layers[{idx}] needs one of 'dims' "
                         "(7 ints R,S,P,Q,C,K,N), 'matmul' ([M,K,N]) "
                         "or 'conv' ([Cin,Cout,kernel,out_hw])")
    dims = obj["dims"]
    if not isinstance(dims, list) or len(dims) != 7 \
            or not all(isinstance(d, int) for d in dims):
        raise ValueError(f"layers[{idx}].dims must be 7 ints "
                         f"(R,S,P,Q,C,K,N), got {dims!r}")
    return Layer(dims=tuple(dims),
                 wstride=int(obj.get("wstride", 1)),
                 hstride=int(obj.get("hstride", 1)),
                 repeat=int(obj.get("repeat", 1)),
                 name=str(obj.get("name", f"layer{idx}")))


def _parse_workload(obj) -> Workload:
    if not isinstance(obj, dict) or "layers" not in obj:
        raise ValueError("workload must be an object with a 'layers' "
                         "list")
    layers = obj["layers"]
    if not isinstance(layers, list) or not layers:
        raise ValueError("workload.layers must be a non-empty list")
    return Workload(layers=tuple(_parse_layer(lay, i)
                                 for i, lay in enumerate(layers)),
                    name=str(obj.get("name", "workload")))


def _parse_config(obj) -> SearchConfig:
    if obj is None:
        return SearchConfig()
    if not isinstance(obj, dict):
        raise ValueError(f"config must be an object, "
                         f"got {_type_name(obj)}")
    kwargs = {}
    for key, val in obj.items():
        if key == "spec":
            if val is None:
                continue
            if val not in SPEC_REGISTRY:
                raise ValueError(
                    f"unknown spec {val!r}; serveable targets: "
                    f"{sorted(SPEC_REGISTRY)}")
            kwargs["spec"] = SPEC_REGISTRY[val]
            continue
        want = _CONFIG_FIELDS.get(key)
        if want is None:
            raise ValueError(f"config.{key} is not a serveable field; "
                             f"allowed: {sorted(_CONFIG_FIELDS)} + "
                             "['spec']")
        if key == "shards" and val is None:
            continue
        if want is float and isinstance(val, int) \
                and not isinstance(val, bool):
            val = float(val)
        if not isinstance(val, want) or (want is int
                                         and isinstance(val, bool)):
            raise ValueError(f"config.{key} must be {want.__name__}, "
                             f"got {_type_name(val)}")
        kwargs[key] = val
    # SearchConfig.__post_init__ enforces the semantic invariants
    # (budget/round_every divisibility, ordering_mode names, ...) and
    # spec resolution runs the SP5xx lint on first compile.
    return SearchConfig(**kwargs)


def parse_search_payload(body: dict,
                         device=DEFAULT_DEVICE) -> SearchRequest:
    """Validate one POST /v1/search payload into a `SearchRequest` on
    `device` (the server's).  Raises ValueError with an actionable
    message on any malformed input — the transport maps that to a
    400."""
    if not isinstance(body, dict):
        raise ValueError(f"payload must be a JSON object, "
                         f"got {_type_name(body)}")
    unknown = sorted(set(body) - set(_REQUEST_FIELDS))
    if unknown:
        raise ValueError(f"unknown request field(s) {unknown}; "
                         f"allowed: {list(_REQUEST_FIELDS)}")
    if "workload" not in body:
        raise ValueError("payload needs a 'workload' object")
    rid = body.get("request_id")
    if rid is not None and not isinstance(rid, str):
        raise ValueError(f"request_id must be a string, "
                         f"got {_type_name(rid)}")
    # priority/deadline_s/segment_budget validate in
    # SearchRequest.__post_init__ (shared with in-process callers).
    return SearchRequest(
        workload=_parse_workload(body["workload"]),
        config=_parse_config(body.get("config")),
        request_id=rid,
        priority=body.get("priority", 0),
        deadline_s=body.get("deadline_s"),
        segment_budget=body.get("segment_budget"),
        device=str(device))


def _outcome_json(out) -> dict:
    d = {"request_id": out.request_id, "status": out.status,
         "ok": out.ok, "error": out.error,
         "degraded": list(out.degraded)}
    if out.result is not None:
        d.update(best_edp=float(out.best_edp), n_evals=int(out.n_evals),
                 history=[[int(e), float(v)] for e, v in out.history])
    return d


def _event_json(ev) -> dict:
    return {"request_id": ev.request_id, "segment": ev.segment,
            "n_segments": ev.n_segments, "n_evals": ev.n_evals,
            "best_edp": float(ev.best_edp), "improved": ev.improved,
            "best_point": (None if ev.best_point is None
                           else list(ev.best_point)),
            "done": ev.done}


class _Handler(BaseHTTPRequestHandler):
    """Routes one HTTP exchange onto the owning `CoSearchServer`."""

    # the transport speaks JSON only; keep-alive default is fine
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> "CoSearchServer":
        return self.server.app

    def log_message(self, fmt, *args):
        self.app.log(fmt % args)

    def _reply(self, code: int, payload: dict) -> None:
        blob = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def _reply_text(self, code: int, text: str) -> None:
        blob = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_POST(self):   # noqa: N802 (http.server API)
        if self.path != "/v1/search":
            self._reply(404, {"error": f"no such endpoint {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"null")
            self._reply(202, self.app.submit_json(body))
        except (ValueError, KeyError, TypeError,
                NotImplementedError) as exc:
            # boundary rejection: malformed JSON, unknown fields, spec
            # lint failures (SpecLintError is a ValueError), features
            # not ported yet
            self._reply(400, {"error": {"type": type(exc).__name__,
                                        "message": str(exc)}})

    def do_GET(self):    # noqa: N802 (http.server API)
        app = self.app
        if self.path == "/v1/healthz":
            self._reply(200, {"ok": True, "busy": app.busy()})
        elif self.path == "/v1/stats":
            self._reply(200, app.stats_json())
        elif self.path == "/v1/frontier":
            self._reply(200, {"frontier": app.frontier_json()})
        elif self.path == "/v1/metrics":
            self._reply_text(200, app.metrics_text())
        elif self.path.startswith("/v1/trace/"):
            rid = self.path[len("/v1/trace/"):]
            code, payload = app.trace_json(rid)
            self._reply(code, payload)
        elif self.path.startswith("/v1/result/"):
            rid = self.path[len("/v1/result/"):]
            code, payload = app.result_json(rid)
            self._reply(code, payload)
        elif self.path.startswith("/v1/events/"):
            rid = self.path[len("/v1/events/"):]
            code, payload = app.events_json(rid)
            self._reply(code, payload)
        else:
            self._reply(404, {"error": f"no such endpoint {self.path}"})


class CoSearchServer:
    """The serving runtime: cooperative core + scheduler thread +
    threaded HTTP transport.

    Usage::

        with CoSearchServer(ServiceConfig(...)) as (host, port):
            ...POST http://host:port/v1/search...

    `port=0` binds an ephemeral port (tests).  All core access is
    serialized under one condition lock; the scheduler thread steps the
    service whenever `busy()` and sleeps on the condition otherwise.
    Every accepted request runs on `device`, checked here.
    """

    def __init__(self, service_cfg: ServiceConfig | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 log=lambda msg: None, device=DEFAULT_DEVICE):
        self.device = str(resolve_device(device))
        self.service = CoSearchService(service_cfg)
        self.log = log
        self._host, self._port = host, port
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> tuple[str, int]:
        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.app = self
        self._httpd.daemon_threads = True
        addr = self._httpd.server_address[:2]
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="cosearch-http", daemon=True),
            threading.Thread(target=self._schedule,
                             name="cosearch-sched", daemon=True),
        ]
        for t in self._threads:
            t.start()
        self.log(f"[server] listening on {addr[0]}:{addr[1]}")
        return addr

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self) -> tuple[str, int]:
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- scheduler ---------------------------------------------------------

    def _schedule(self) -> None:
        """Drive the cooperative core: one `step()` per loop while work
        is pending, condition-wait when idle.  Fatal task faults are
        contained into error outcomes (`contain_fatal`) so the loop —
        and the server — outlives any single poisoned request."""
        while not self._stop.is_set():
            with self._cond:
                if not self.service.busy():
                    self._cond.wait(timeout=0.1)
                    continue
                self.service.step(contain_fatal=True)
                self._cond.notify_all()

    def busy(self) -> bool:
        with self._cond:
            return self.service.busy()

    # -- endpoint bodies (shared with in-process tests) --------------------

    def submit_json(self, body: dict) -> dict:
        req = parse_search_payload(body, device=self.device)
        with self._cond:
            before = self.service.stats()["faults"]["dedup_hits"]
            rid = self.service.submit(req)
            dedup = self.service.stats()["faults"]["dedup_hits"] > before
            self._cond.notify_all()
        return {"request_id": rid, "deduplicated": dedup}

    def result_json(self, rid: str) -> tuple[int, dict]:
        with self._cond:
            out = self.service.outcome(rid)
            if out is not None:
                return 200, _outcome_json(out)
            if self.service.knows(rid):
                return 202, {"request_id": rid, "status": "pending",
                             "events": len(self.service.events(rid))}
            return 404, {"error": f"unknown request_id {rid!r}"}

    def events_json(self, rid: str) -> tuple[int, dict]:
        with self._cond:
            if not self.service.knows(rid):
                return 404, {"error": f"unknown request_id {rid!r}"}
            evs = self.service.events(rid)
            return 200, {"request_id": rid,
                         "events": [_event_json(ev) for ev in evs]}

    def stats_json(self) -> dict:
        with self._cond:
            return self.service.stats()

    def metrics_text(self) -> str:
        with self._cond:
            return self.service.metrics_text()

    def trace_json(self, rid: str) -> tuple[int, dict]:
        with self._cond:
            tree = self.service.request_trace(rid)
        if tree is None:
            return 404, {"error": f"unknown request_id {rid!r}"}
        return 200, {"request_id": rid, "trace": tree}

    def frontier_json(self) -> list:
        with self._cond:
            return [[rid, e, lat]
                    for rid, e, lat in self.service.pareto_frontier()]

    def wait_idle(self, timeout: float = 300.0) -> bool:
        """Block until every submitted request has an outcome (tests /
        graceful shutdown).  Returns False on timeout."""
        with self._cond:
            return self._cond.wait_for(
                lambda: not self.service.busy(), timeout=timeout)
