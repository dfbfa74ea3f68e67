"""Co-search serving layer: a persistent, fault-hardened search server.

The PyTorch port of `repro.serve.cosearch_service`.  Every request
runs on its own `device` (``"cuda"`` unless the caller asks for the
CPU), a device or a sequence of devices: the "pop" mesh its padded
population shards over.  Requests batch only with requests on the same
device tuple, and a request whose device is unusable, or whose
``shards`` does not fit its devices, is refused when it is submitted.

`CoSearchService` turns the one-loop engine into infrastructure: it
accepts a stream of `repro.api.SearchRequest`s and answers each one
with the same result the synchronous entry points would return, while
amortizing engine compiles across the stream — and it keeps answering
under injected failure (chaos-tested: `runtime.chaos`).

Request lifecycle
-----------------
1. **submit** — the request's workload is canonicalized
   (`archspec.bucket_workload`: dims pad up to the divisor-rich ladder,
   layer names canonicalize) so heterogeneous queries collapse onto a
   bounded set of engine shapes; identical request *fingerprints*
   dedup onto one in-flight task (the duplicate shares its events and
   outcome; counted in `stats()["faults"]["dedup_hits"]`); the request
   joins the pending queue with its priority/deadline/segment budget.
2. **batching** — pending requests group by batch key: the canonical
   workload + the spec's structural `engine_group_key` + every config
   field the traced engine reads (seeds excluded — requests that differ
   only in seed share one compiled program).  Same-spec groups batch
   *exactly*: each request's start population is generated with its own
   seeded RNG stream (identical to `dosa_search`'s) and the populations
   are stacked along the existing population axis — every population op
   in the fused engine is per-member, so each request's slice is
   bit-identical to running it alone.  Mixed-spec groups (same
   structural group, different numeric tables) batch through the fleet
   engine (`fleet.search_group_results`) with per-request configs.
3. **scheduling** — `step()` advances ONE task by one rounding segment,
   chosen by weighted round-robin: each runnable task earns credit
   proportional to `1 + max(request priorities)` per scheduling round
   and the highest-credit task runs, so high-priority work gets a
   proportionally larger share without starving the rest.  Requests
   whose wall-clock `deadline_s` or `segment_budget` expires finalize
   immediately with a structured ``timeout`` outcome carrying the
   best-so-far partial result; their population slots keep advancing
   inertly (removing them would force a recompile).
4. **fault handling** — a segment that raises is classified by the
   shared `runtime.faults` taxonomy: *transient* faults (RuntimeError /
   OSError / FloatingPointError) roll back to the last checkpoint and
   retry with per-task exponential backoff; a *poison* fault (the same
   signature re-failing a bit-identical replay — e.g. a ValueError that
   proves deterministic) splits the batch into singleton tasks so
   sibling requests replay cleanly, and the poison singleton is
   quarantined with a structured ``error`` outcome instead of burning
   the batch's retry budget; *fatal* faults propagate immediately.
   Graceful degradation: a failing learned latency model strips to the
   analytical model, and a multi-device shard loss re-resolves the
   engine to ``shards=1`` — both continue and flag the outcome
   ``degraded``.
5. **checkpoint / resume / GC** — with `checkpoint_dir` set, the task
   state checkpoints every `checkpoint_every` segments via
   `runtime.search_checkpoint`; a killed server resumes the task
   bit-identically, restore falls back past torn/partial checkpoint
   files to the previous good step, completed tasks delete their
   checkpoints on drain, and total checkpoint disk is bounded by an
   LRU sweep (`checkpoint_max_bytes`).
6. **done** — `outcome(request_id)` / `drain()` return `SearchOutcome`s
   whose results are seeded-identical to direct `dosa_search` on the
   canonical workload (bit-identical to the original workload whenever
   its dims already sit on the canonical ladder, since padding is then
   the identity and layer names never enter the math).

Bucketing policy: padding a dim only adds MACs/words, so the canonical
problem's EDP upper-bounds the original's; off-ladder queries trade a
< 34%-per-dim problem inflation for a bounded set of engines (policy
test: tests/test_torch_serve.py::test_bucketing_policy).

The transport front-end (`serve.server`) drives this cooperative core
from a single scheduler thread behind a threaded HTTP/JSON endpoint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from ..api import SearchOutcome, SearchRequest
from ..core.archspec import (GEMMINI_SPEC, bucket_workload,
                             engine_group_key, resolve_spec)
from ..core.fleet import (_TRACED_CFG_FIELDS, fleet_engine_cache_stats,
                          search_group_results)
from ..core.mapping import stack_mappings, unstack_mappings
from ..core.oracle import evaluate_workload
from ..core.problem import Workload
from ..core.search import (SearchConfig, _Recorder, _generate_start_point,
                           _segment_lengths, engine_cache_stats,
                           fused_engines, orders_from_population,
                           run_fused,
                           theta_from_population)
from ..device import resolve_devices
from ..launch.mesh import auto_pop_shards, make_pop_mesh
from ..obs import telemetry as _obs
from ..obs.history import HistoryRecorder
from ..runtime import faults
from ..runtime import search_checkpoint as sckpt
from ..sharding.rules import member_spec


@dataclasses.dataclass
class ServiceConfig:
    """Serving policy knobs."""
    # canonicalize query shapes (see module doc)
    bucket_workloads: bool = True
    batch_max: int = 8              # max requests fused into one batch task
    member_buckets: tuple = (1, 2, 4, 8, 16)  # canonical population sizes
    checkpoint_dir: str | None = None         # None: no persistence
    checkpoint_every: int = 1       # segments between checkpoints
    max_restarts: int = 2           # transient retries per task
    backoff_base_s: float = 0.02    # first-retry backoff delay
    backoff_factor: float = 2.0     # backoff growth per retry
    backoff_max_s: float = 1.0      # backoff ceiling
    gc_completed: bool = True       # delete checkpoints on drain
    checkpoint_max_bytes: int | None = None   # LRU disk sweep bound
    # Injected clock/sleep (rule ND202: engine code never reads the
    # wall clock directly); tests inject fakes for determinism.
    clock_fn: Callable[[], float] = time.monotonic
    sleep_fn: Callable[[float], None] = time.sleep
    # Observability: request-lifecycle span budget and the bound on the
    # npz-backed search-history store (learned-seeding training rows).
    trace_max_spans: int = 100_000
    history_max_rows: int = 4096

    def retry_policy(self) -> faults.RetryPolicy:
        return faults.RetryPolicy(max_retries=self.max_restarts,
                                  backoff_base_s=self.backoff_base_s,
                                  backoff_factor=self.backoff_factor,
                                  backoff_max_s=self.backoff_max_s)


@dataclasses.dataclass
class ProgressEvent:
    """One streamed increment of one request's search."""
    request_id: str
    segment: int                    # segments completed so far
    n_segments: int
    n_evals: int
    best_edp: float                 # best-EDP-so-far
    improved: bool                  # did this segment improve the best?
    best_point: tuple | None        # (energy, latency) when improved
    done: bool


class _SplitBatch(Exception):
    """Control flow task -> service: a poison fault hit a multi-request
    batch; re-form it as singleton tasks so siblings replay cleanly."""

    def __init__(self, record: dict):
        super().__init__(record.get("message", "poison fault"))
        self.record = record


class _QuarantineTask(Exception):
    """Control flow task -> service: this (singleton) task's input is
    poison; finalize it with a structured error outcome."""

    def __init__(self, record: dict):
        super().__init__(record.get("message", "poison fault"))
        self.record = record


def _spec_of(cfg: SearchConfig):
    return cfg.spec if cfg.spec is not None else GEMMINI_SPEC


def _pad_size(n: int, buckets: tuple) -> int:
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def _task_weight(requests: list[SearchRequest]) -> int:
    """Weighted-round-robin share of one task: proportional to its most
    urgent member, never below 1."""
    return max(1, 1 + max(r.priority for r in requests))


def _best_point(rec: _Recorder):
    """(energy, latency) Pareto coordinates of a recorder's current
    best, re-evaluated through the oracle like `fleet._fleet_entry`."""
    best = rec.best
    if not best.best_mappings or not np.isfinite(best.best_edp):
        return None
    _, results = evaluate_workload(best.best_mappings,
                                   rec.workload.layers, spec=rec.cspec)
    energy = sum(r.energy * layer.repeat
                 for r, layer in zip(results, rec.workload.layers))
    latency = sum(r.latency * layer.repeat
                  for r, layer in zip(results, rec.workload.layers))
    return (float(energy), float(latency))


def _timeout_record(reason: str) -> dict:
    return {"fault_class": "timeout", "type": "Deadline",
            "message": f"request {reason} expired", "reason": reason,
            "retries": 0}


class _BatchTask:
    """One same-spec batch advancing through the fused single-target
    engine, one rounding segment per `advance()` call."""

    def __init__(self, svc_cfg: ServiceConfig, workload: Workload,
                 requests: list[SearchRequest]):
        self.svc_cfg = svc_cfg
        self.workload = workload
        self.requests = sorted(requests, key=lambda r: r.request_id)
        self.cfg0 = self.requests[0].config
        self.devices = resolve_devices(self.requests[0].device)
        self.cspec = resolve_spec(self.cfg0.spec)
        self.seg_lens = _segment_lengths(self.cfg0.steps,
                                         self.cfg0.round_every)
        self.task_id = hashlib.sha256("/".join(
            r.request_id for r in self.requests).encode()).hexdigest()[:16]
        self.weight = _task_weight(self.requests)
        self.retry = faults.RetryState(svc_cfg.retry_policy())
        self.recs: list[_Recorder] = []
        self.spans: list[tuple[int, int]] = []
        self.theta: np.ndarray | None = None   # (P_real, L, 2, nl, 7)
        self.orders: np.ndarray | None = None  # (P_real, L, n_levels)
        self.seg_done = 0
        self.started = False
        self.done = False
        self.degraded: set[str] = set()
        self.finalized: dict[str, SearchOutcome] = {}   # timed-out rids
        self.checkpoint_hook: Callable | None = None
        self._force_shards1 = False
        # Observability taps, wired by the service at registration:
        # trace_event(name, **attrs) fans a fault/degrade event out to
        # every member request's root span; history records one row per
        # (request, segment) boundary.
        self.trace_event: Callable | None = None
        self.history: HistoryRecorder | None = None

    def _emit(self, name: str, **attrs) -> None:
        if self.trace_event is not None:
            self.trace_event(name, **attrs)

    @property
    def restarts(self) -> int:
        return self.retry.retries

    # -- lifecycle ---------------------------------------------------------

    def _fresh_recorders(self):
        self.recs = [_Recorder(self.workload, r.config, self.cspec)
                     for r in self.requests]
        lo = 0
        self.spans = []
        for r in self.requests:
            hi = lo + r.config.n_start_points
            self.spans.append((lo, hi))
            lo = hi

    def _start_fresh(self):
        """Generate every request's start population with its own seeded
        RNG stream — the exact `_dosa_search_fused` protocol per
        request, so accounting matches a direct run member-for-member."""
        self._fresh_recorders()
        thetas, orders = [], []
        for req, rec in zip(self.requests, self.recs):
            rcfg = req.config
            rng = np.random.default_rng(rcfg.seed)
            starts, best_start_edp = [], float("inf")
            for _ in range(rcfg.n_start_points):
                mappings, edp0, best_start_edp = _generate_start_point(
                    self.workload, rcfg, rng, best_start_edp, rec)
                rec.best.start_edps.append(edp0)
                starts.append(mappings)
            for mappings in starts:
                rec.record(mappings)
            thetas.append(theta_from_population(starts,
                                                self.cspec.free_mask))
            orders.append(orders_from_population(starts))
        self.theta = np.concatenate(thetas).astype(np.float32)
        self.orders = np.concatenate(orders)
        self.seg_done = 0

    def start(self) -> None:
        if self.started:
            return
        self.started = True
        restored = None
        if self.svc_cfg.checkpoint_dir is not None:
            restored = sckpt.restore_task(self.svc_cfg.checkpoint_dir,
                                          self.task_id)
        if restored is not None:
            seg_done, theta, orders, rec_states = restored
            self._fresh_recorders()
            for rec, rs in zip(self.recs, rec_states):
                sckpt.load_recorder(rec, rs)
            self.theta, self.orders = theta, orders
            self.seg_done = seg_done
        else:
            self._start_fresh()
            self._checkpoint()   # seg-0 baseline: rollback target
        if self.seg_done >= len(self.seg_lens):
            self.done = True

    def _checkpoint(self) -> None:
        if self.svc_cfg.checkpoint_dir is None:
            return
        sckpt.save_task(self.svc_cfg.checkpoint_dir, self.task_id,
                        self.seg_done, self.theta, self.orders,
                        [sckpt.recorder_state(rec) for rec in self.recs])
        if self.checkpoint_hook is not None:
            # chaos taps this to tear the file just written
            self.checkpoint_hook(self.svc_cfg.checkpoint_dir,
                                 self.task_id, self.seg_done)

    def _rollback(self) -> None:
        restored = None
        if self.svc_cfg.checkpoint_dir is not None:
            restored = sckpt.restore_task(self.svc_cfg.checkpoint_dir,
                                          self.task_id)
        if restored is not None:
            seg_done, theta, orders, rec_states = restored
            self._fresh_recorders()
            for rec, rs in zip(self.recs, rec_states):
                sckpt.load_recorder(rec, rs)
            self.theta, self.orders = theta, orders
            self.seg_done = seg_done
        else:
            # No persistence (or every checkpoint torn): start
            # generation is deterministic, so a full replay from
            # scratch reaches the same state.
            self._start_fresh()

    # -- degradation -------------------------------------------------------

    def _strip_surrogate(self) -> bool:
        """Learned-latency-model failure: fall back to the analytical
        model and restart the task fresh (stale surrogate-era
        checkpoints are deleted).  Flags every outcome ``degraded``."""
        if self.cfg0.surrogate is None \
                or "surrogate_fallback" in self.degraded:
            return False
        self.degraded.add("surrogate_fallback")
        self.requests = [
            dataclasses.replace(
                r, config=dataclasses.replace(r.config, surrogate=None))
            for r in self.requests]
        self.cfg0 = self.requests[0].config
        if self.svc_cfg.checkpoint_dir is not None:
            sckpt.delete_task(self.svc_cfg.checkpoint_dir, self.task_id)
        self._start_fresh()
        self._checkpoint()
        return True

    # -- one segment -------------------------------------------------------

    def advance(self, fault_hook: Callable | None = None
                ) -> list[ProgressEvent]:
        """Run the next rounding segment as one fused device dispatch,
        replay per-request oracle accounting over the read-back, and
        stream one event per live request.

        Fault handling (shared taxonomy, `runtime.faults`): transient
        faults roll back to the last checkpoint and retry after
        exponential backoff; a shard loss re-resolves to ``shards=1``
        (degraded); a surrogate failure strips to the analytical model
        (degraded); deterministic re-failure raises `_SplitBatch` /
        `_QuarantineTask` for the service to contain."""
        self.start()
        if self.done:
            return []
        prev_best = [rec.best.best_edp for rec in self.recs]
        while True:
            try:
                self._advance_once(fault_hook)
                break
            except Exception as exc:   # classified below; fatal re-raised
                if isinstance(exc, faults.ShardLossFault) \
                        and not self._force_shards1:
                    # degrade to the single-shard engine and continue
                    self._force_shards1 = True
                    self.degraded.add("shard_fallback")
                    self._emit("degrade", mode="shard_fallback")
                    self._rollback()
                    continue
                if isinstance(exc, faults.SurrogateFault) \
                        and self._strip_surrogate():
                    self._emit("degrade", mode="surrogate_fallback")
                    continue
                action, delay = self.retry.next_action(exc)
                if action == faults.RETRY:
                    self._emit("retry",
                               fault_class=faults.classify(exc),
                               type=type(exc).__name__,
                               retries=self.retry.retries)
                    if delay > 0.0:
                        self._emit("backoff", delay_s=delay)
                        self.svc_cfg.sleep_fn(delay)
                    self._rollback()
                    continue
                # poison or exhausted budget: surrogate configs get one
                # analytical-fallback attempt before giving up
                if self._strip_surrogate():
                    self._emit("degrade", mode="surrogate_fallback")
                    continue
                if action == faults.QUARANTINE:
                    if len(self.requests) > 1:
                        raise _SplitBatch(self.retry.last_fault) from exc
                    raise _QuarantineTask(self.retry.last_fault) from exc
                raise
        events = []
        n_seg = len(self.seg_lens)
        if self.seg_done >= n_seg:
            self.done = True
        for req, rec, pb in zip(self.requests, self.recs, prev_best):
            if req.request_id in self.finalized:
                continue   # timed out earlier; slot advances inertly
            improved = rec.best.best_edp < pb
            events.append(ProgressEvent(
                request_id=req.request_id, segment=self.seg_done,
                n_segments=n_seg, n_evals=rec.evals,
                best_edp=rec.best.best_edp, improved=improved,
                best_point=_best_point(rec) if improved else None,
                done=self.done))
        return events

    def _advance_once(self, fault_hook: Callable | None) -> None:
        if fault_hook is not None:
            fault_hook(self.task_id, self.seg_done,
                       tuple(r.request_id for r in self.requests))
        n_steps = self.seg_lens[self.seg_done]

        p_real = self.theta.shape[0]
        p_pad = _pad_size(p_real, self.svc_cfg.member_buckets)
        theta = self.theta
        orders = self.orders
        if p_pad > p_real:
            # Replicate the last member: every population op is
            # per-member, so padding never perturbs the real slices.
            pad = p_pad - p_real
            theta = np.concatenate([theta, np.repeat(theta[-1:], pad, 0)])
            orders = np.concatenate([orders,
                                     np.repeat(orders[-1:], pad, 0)])
        # The service rides the sharded engine transparently: the padded
        # population shards over the "pop" mesh of the request's devices
        # (per-member ops keep the read-back bit-identical at any shard
        # count), bounded by the batch config's `shards` knob.  After a
        # shard loss the task is pinned to the single-device engine
        # (bit-identical results).
        shards = 1 if self._force_shards1 else \
            auto_pop_shards(p_pad, self.cfg0.shards, self.devices)
        mesh = make_pop_mesh(shards, self.devices)
        engines = fused_engines(self.workload, self.cfg0, mesh)
        dev = self.devices[0]
        (f_seg, o_seg, _), _best = run_fused(
            engines, mesh,
            (torch.from_numpy(theta.astype(np.float32)).to(dev),
             torch.from_numpy(orders).to(dev)),
            (member_spec(4), member_spec(2)), n_full=1, rem=0,
            seg_len=n_steps)
        f_seg = f_seg.cpu().numpy().astype(float)[0]  # (P_pad, L, 2, nl, 7)
        o_seg = o_seg.cpu().numpy()[0]                # (P_pad, L, n_levels)

        rounded = [unstack_mappings(f_seg[p], o_seg[p])
                   for p in range(p_real)]
        for rec, (a, b) in zip(self.recs, self.spans):
            rec.count(n_steps * (b - a))
            for p in range(a, b):
                rec.record(rounded[p])
        # The rounded population IS the next segment's start state: the
        # fused engine restarts theta from the rounded integer logs each
        # segment, so the host rebuild is bit-identical to the device
        # carry (the PR-4 read-back guarantee).
        self.theta = theta_from_population(rounded,
                                           self.cspec.free_mask
                                           ).astype(np.float32)
        self.orders = orders_from_population(rounded)
        self.seg_done += 1
        self._record_history()
        if (self.seg_done % self.svc_cfg.checkpoint_every == 0
                or self.seg_done >= len(self.seg_lens)):
            self._checkpoint()

    def _record_history(self) -> None:
        """One search-history row per live request at this segment
        boundary: the running best EDP + its rounded mapping — the
        learned-seeding training data (`obs.history`)."""
        if self.history is None:
            return
        spec_fp = getattr(self.cspec, "name", "spec")
        for req, rec in zip(self.requests, self.recs):
            if req.request_id in self.finalized:
                continue
            best = rec.best
            if not best.best_mappings:
                continue
            fs, ords = stack_mappings(best.best_mappings)
            self.history.record(
                spec=spec_fp, workload=self.workload.name,
                segment=self.seg_done, best_edp=best.best_edp,
                factors=fs, orders=ords, request_id=req.request_id)

    # -- timeouts ----------------------------------------------------------

    def expire_request(self, request_id: str,
                       reason: str) -> SearchOutcome | None:
        """Finalize one request whose deadline/segment budget expired:
        a structured ``timeout`` outcome carrying the best-so-far
        partial result.  Sibling members are untouched (the expired
        slot keeps advancing inertly — dropping it would recompile)."""
        if self.done or request_id in self.finalized:
            return None
        result = None
        for req, rec in zip(self.requests, self.recs):
            if req.request_id == request_id:
                result = rec.finish() if self.recs else None
        out = SearchOutcome(request_id=request_id, result=result,
                            status="timeout",
                            error=_timeout_record(reason),
                            degraded=tuple(sorted(self.degraded)))
        self.finalized[request_id] = out
        if len(self.finalized) == len(self.requests):
            self.done = True   # nobody left to serve; stop burning steps
        return out

    # -- results -----------------------------------------------------------

    def final_outcomes(self) -> list[tuple[SearchRequest, SearchOutcome]]:
        """(request, outcome) for every request not already finalized by
        a timeout."""
        status = "degraded" if self.degraded else "ok"
        out = []
        for req, rec in zip(self.requests, self.recs):
            if req.request_id in self.finalized:
                continue
            out.append((req, SearchOutcome(
                request_id=req.request_id, result=rec.finish(),
                status=status, degraded=tuple(sorted(self.degraded)))))
        return out


class _GroupTask:
    """A mixed-spec batch (same structural `engine_group_key`, different
    numeric tables): one fleet-engine shot with per-request configs.
    Runs to completion in a single `advance()` (no segment streaming —
    the fleet engine owns its whole segment loop)."""

    def __init__(self, svc_cfg: ServiceConfig, workload: Workload,
                 requests: list[SearchRequest]):
        self.svc_cfg = svc_cfg
        self.workload = workload
        self.requests = sorted(requests, key=lambda r: r.request_id)
        self.devices = resolve_devices(self.requests[0].device)
        self.task_id = hashlib.sha256(("grp/" + "/".join(
            r.request_id for r in self.requests)).encode()
            ).hexdigest()[:16]
        self.weight = _task_weight(self.requests)
        self.retry = faults.RetryState(svc_cfg.retry_policy())
        self.seg_done = 0
        self.started = False
        self.done = False
        self.degraded: set[str] = set()
        self.finalized: dict[str, SearchOutcome] = {}
        self.checkpoint_hook: Callable | None = None
        self.trace_event: Callable | None = None
        self.history: HistoryRecorder | None = None

    def _emit(self, name: str, **attrs) -> None:
        if self.trace_event is not None:
            self.trace_event(name, **attrs)

    def advance(self, fault_hook: Callable | None = None
                ) -> list[ProgressEvent]:
        if self.done:
            return []
        self.started = True
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(self.task_id, self.seg_done,
                               tuple(r.request_id for r in self.requests))
                specs = [_spec_of(r.config) for r in self.requests]
                cfgs = [r.config for r in self.requests]
                results = search_group_results(self.workload, specs,
                                               self.requests[0].config,
                                               fused=True, cfgs=cfgs,
                                               device=self.devices)
                break
            except Exception as exc:   # classified; fatal re-raised
                action, delay = self.retry.next_action(exc)
                if action == faults.RETRY:
                    self._emit("retry",
                               fault_class=faults.classify(exc),
                               type=type(exc).__name__,
                               retries=self.retry.retries)
                    if delay > 0.0:
                        self._emit("backoff", delay_s=delay)
                        self.svc_cfg.sleep_fn(delay)
                    continue   # stateless: a full rerun IS the rollback
                if action == faults.QUARANTINE:
                    if len(self.requests) > 1:
                        raise _SplitBatch(self.retry.last_fault) from exc
                    raise _QuarantineTask(self.retry.last_fault) from exc
                raise
        self._results = results
        self.seg_done = 1
        self.done = True
        if self.history is not None:
            for req, sr in zip(self.requests, results):
                mappings = getattr(sr, "best_mappings", None)
                if not mappings:
                    continue
                fs, ords = stack_mappings(mappings)
                self.history.record(
                    spec=getattr(_spec_of(req.config), "name", "spec"),
                    workload=self.workload.name, segment=1,
                    best_edp=sr.best_edp, factors=fs, orders=ords,
                    request_id=req.request_id)
        events = []
        for req, sr in zip(self.requests, results):
            if req.request_id in self.finalized:
                continue
            events.append(ProgressEvent(
                request_id=req.request_id, segment=1, n_segments=1,
                n_evals=sr.n_evals, best_edp=sr.best_edp, improved=True,
                best_point=None, done=True))
        return events

    def expire_request(self, request_id: str,
                       reason: str) -> SearchOutcome | None:
        """Group tasks run in one shot: a deadline observed before the
        shot finalizes the request with an empty timeout outcome."""
        if self.done or request_id in self.finalized:
            return None
        out = SearchOutcome(request_id=request_id, result=None,
                            status="timeout",
                            error=_timeout_record(reason))
        self.finalized[request_id] = out
        if len(self.finalized) == len(self.requests):
            self.done = True
        return out

    def final_outcomes(self) -> list[tuple[SearchRequest, SearchOutcome]]:
        status = "degraded" if self.degraded else "ok"
        out = []
        for req, sr in zip(self.requests, self._results):
            if req.request_id in self.finalized:
                continue
            out.append((req, SearchOutcome(
                request_id=req.request_id, result=sr, status=status,
                degraded=tuple(sorted(self.degraded)))))
        return out


class CoSearchService:
    """Persistent co-search server (single-threaded, cooperative).

    `submit()` enqueues requests (deduping identical fingerprints);
    `step()` advances the weighted-round-robin-chosen task by one
    segment and returns the streamed events; `drain()` runs everything
    to completion and returns `{request_id: SearchOutcome}` — including
    structured ``timeout``/``error`` outcomes for expired/quarantined
    requests."""

    def __init__(self, cfg: ServiceConfig | None = None):
        self.cfg = ServiceConfig() if cfg is None else cfg
        self._pending: list[SearchRequest] = []
        self._tasks: list = []
        self._events: dict[str, list[ProgressEvent]] = {}
        self._outcomes: dict[str, SearchOutcome] = {}
        self._frontier: dict[str, tuple] = {}   # request_id -> (E, L)
        self.fault_hook: Callable | None = None
        self.checkpoint_hook: Callable | None = None
        # dedup + scheduling state
        self._fp_to_rid: dict[str, str] = {}
        self._aliases: dict[str, str] = {}      # duplicate rid -> canonical
        self._req_by_id: dict[str, SearchRequest] = {}
        self._deadlines: dict[str, faults.Deadline] = {}
        self._credits: dict[str, float] = {}    # task_id -> WRR credit
        self._task_order: dict[str, int] = {}   # task_id -> creation idx
        self._task_seq = 0
        # Observability spine: the service owns one tracer (request
        # lifecycle spans on the *injected* clock) plus one metrics
        # registry — every count `stats()` reports lives in the
        # registry, not in hand-maintained ints, so `/v1/metrics` and
        # `stats()` can never disagree.
        self.tracer = _obs.Tracer(clock=self.cfg.clock_fn,
                                  max_spans=self.cfg.trace_max_spans)
        self.metrics = _obs.MetricsRegistry()
        self.history = HistoryRecorder(max_rows=self.cfg.history_max_rows)
        m = self.metrics
        self._c_submitted = m.counter(
            "serve_requests_submitted_total", "requests accepted")
        self._c_completed = m.counter(
            "serve_requests_completed_total",
            "requests finalized, by outcome status", ("status",))
        self._c_segments = m.counter(
            "serve_segments_total", "rounding segments advanced")
        self._c_batches = m.counter(
            "serve_batches_total", "tasks formed, by engine kind",
            ("kind",))
        self._c_dedup = m.counter(
            "serve_dedup_hits_total", "requests deduped onto an "
            "in-flight fingerprint")
        self._c_quarantined = m.counter(
            "serve_quarantined_total", "requests quarantined as poison")
        self._c_splits = m.counter(
            "serve_batch_splits_total", "poison batch splits")
        self._c_timeouts = m.counter(
            "serve_timeouts_total", "deadline/segment-budget expiries")
        self._c_degraded = m.counter(
            "serve_degraded_requests_total", "requests answered on a "
            "degraded path")
        self._c_retries = m.counter(
            "serve_retries_total", "transient-fault retries")
        self._c_backoff = m.counter(
            "serve_backoff_seconds_total", "backoff slept before "
            "retries")
        self._c_fault_events = m.counter(
            "serve_fault_events_total", "fault-path span events, by "
            "kind", ("event",))
        self._h_request = m.histogram(
            "serve_request_seconds", "submit-to-finalize latency")
        # request-lifecycle span bookkeeping (rid -> span ids)
        self._root_span: dict[str, int] = {}
        self._queue_span: dict[str, int] = {}
        self._submit_t: dict[str, float] = {}
        self._gc = None
        if self.cfg.checkpoint_dir is not None:
            self._gc = sckpt.CheckpointGC(self.cfg.checkpoint_dir,
                                          self.cfg.checkpoint_max_bytes)

    # -- intake ------------------------------------------------------------

    def submit(self, req: SearchRequest) -> str:
        """Enqueue one single-target request; returns its request_id.

        Cross-request dedup: a request whose deterministic fingerprint
        matches one already pending / in flight / completed attaches to
        that task instead of spawning a new one — it shares the
        original's events and outcome (`stats()` counts the hit).  The
        service always runs the fused population engine
        (`population`/`fused` hints apply to the synchronous API only).

        Refused here, before any work starts: portfolio requests, a
        ``shards`` outside the request's devices or not dividing its
        padded population (ValueError, with `auto_pop_shards`' message),
        and a device that cannot run (no GPU for ``"cuda"``)."""
        if req.is_fleet:
            raise ValueError("the service batches single-target requests; "
                             "portfolio queries go through "
                             "api.run_request/fleet_search")
        auto_pop_shards(
            _pad_size(req.config.n_start_points, self.cfg.member_buckets),
            req.config.shards, req.device)
        fp = req.fingerprint()
        canon = self._fp_to_rid.get(fp)
        if canon is not None:
            self._c_dedup.inc()
            root = self._root_span.get(canon)
            if root is not None:
                self.tracer.add_event(root, "dedup_hit",
                                      alias=req.request_id)
            if req.request_id != canon:
                self._aliases[req.request_id] = canon
            return req.request_id
        self._fp_to_rid[fp] = req.request_id
        self._req_by_id[req.request_id] = req
        if req.deadline_s is not None:
            self._deadlines[req.request_id] = faults.Deadline(
                self.cfg.clock_fn, req.deadline_s)
        self._pending.append(req)
        self._events.setdefault(req.request_id, [])
        # request lifecycle trace: root span (open until finalize) with
        # a queue_wait child that closes at batch join
        self._c_submitted.inc()
        rid = req.request_id
        root = self.tracer.start_span(
            "request", request_id=rid,
            workload=req.workload.name, priority=req.priority)
        self.tracer.add_event(root, "submitted")
        self._root_span[rid] = root
        self._queue_span[rid] = self.tracer.start_span(
            "queue_wait", parent_id=root)
        self._submit_t[rid] = self.cfg.clock_fn()
        return req.request_id

    def _rid(self, request_id: str) -> str:
        return self._aliases.get(request_id, request_id)

    def _canon_workload(self, req: SearchRequest) -> Workload:
        return (bucket_workload(req.workload) if self.cfg.bucket_workloads
                else req.workload)

    def _batch_key(self, req: SearchRequest) -> tuple:
        cfg = req.config
        wl = self._canon_workload(req)
        traced = tuple(getattr(cfg, f) for f in _TRACED_CFG_FIELDS)
        extra = (cfg.fixed_hw, cfg.fix_pe_only, cfg.reject_factor,
                 cfg.max_reject_tries, cfg.latency_model,
                 id(cfg.surrogate) if cfg.surrogate is not None else None)
        device = tuple(str(d) for d in resolve_devices(req.device))
        return (engine_group_key(_spec_of(cfg)), wl, traced, extra, device)

    def _trace_event_hook(self, task) -> Callable:
        """Fan a task fault/degrade event out to every member request's
        root span (+ the fault-event counter family)."""
        def emit(name: str, **attrs) -> None:
            self._c_fault_events.inc(event=name)
            if name == "retry":
                self._c_retries.inc()
            elif name == "backoff":
                self._c_backoff.inc(attrs.get("delay_s", 0.0))
            for r in task.requests:
                root = self._root_span.get(r.request_id)
                if root is not None:
                    self.tracer.add_event(root, name, **attrs)
        return emit

    def _register_task(self, task) -> None:
        task.checkpoint_hook = self.checkpoint_hook
        task.trace_event = self._trace_event_hook(task)
        task.history = self.history
        self._tasks.append(task)
        self._credits[task.task_id] = 0.0
        self._task_order[task.task_id] = self._task_seq
        self._task_seq += 1
        for r in task.requests:
            rid = r.request_id
            q = self._queue_span.pop(rid, None)
            if q is not None:
                self.tracer.end_span(q)
            root = self._root_span.get(rid)
            if root is not None:
                self.tracer.add_event(root, "batch_join",
                                      task_id=task.task_id,
                                      batch_size=len(task.requests))

    def _form_batches(self) -> None:
        groups: dict[tuple, list[SearchRequest]] = {}
        for req in self._pending:
            groups.setdefault(self._batch_key(req), []).append(req)
        self._pending = []
        for key, reqs in groups.items():
            wl = self._canon_workload(reqs[0])
            for lo in range(0, len(reqs), self.cfg.batch_max):
                chunk = reqs[lo:lo + self.cfg.batch_max]
                specs = {_spec_of(r.config) for r in chunk}
                if len(specs) == 1:
                    self._register_task(_BatchTask(self.cfg, wl, chunk))
                    self._c_batches.inc(kind="fused")
                else:
                    self._register_task(_GroupTask(self.cfg, wl, chunk))
                    self._c_batches.inc(kind="group")

    # -- scheduling --------------------------------------------------------

    def _runnable(self) -> list:
        return [t for t in self._tasks if not t.done]

    def _next_task(self):
        """Weighted round-robin: every runnable task earns `weight`
        credit per scheduling round; the richest runs and pays the
        round's total back.  Long-run share converges to
        weight/sum(weights); ties break by task creation order."""
        runnable = self._runnable()
        if not runnable:
            return None
        total = sum(t.weight for t in runnable)
        for t in runnable:
            self._credits[t.task_id] += t.weight
        chosen = max(runnable,
                     key=lambda t: (self._credits[t.task_id],
                                    -self._task_order[t.task_id]))
        self._credits[chosen.task_id] -= total
        return chosen

    def _expire_requests(self) -> None:
        """Finalize requests whose wall-clock deadline or segment
        budget expired with a structured ``timeout`` outcome (partial
        best-so-far result when the task has started)."""
        for task in self._tasks:
            if task.done:
                continue
            for req in list(task.requests):
                rid = req.request_id
                if rid in self._outcomes:
                    continue
                dl = self._deadlines.get(rid)
                reason = None
                if dl is not None and dl.expired():
                    reason = "deadline"
                elif (req.segment_budget is not None
                        and task.seg_done >= req.segment_budget):
                    reason = "segment_budget"
                if reason is None:
                    continue
                out = task.expire_request(rid, reason)
                if out is not None:
                    self._c_timeouts.inc()
                    root = self._root_span.get(rid)
                    if root is not None:
                        self.tracer.add_event(root, "timeout",
                                              reason=reason)
                    self._finalize(rid, out)
            if task.done:
                self._retire(task)

    # -- progress ----------------------------------------------------------

    def busy(self) -> bool:
        """Is there pending or in-flight work for `step()` to advance?"""
        return bool(self._pending) or any(not t.done for t in self._tasks)

    def knows(self, request_id: str) -> bool:
        """Was this request_id (or an alias of it) ever submitted?"""
        return self._rid(request_id) in self._events

    def step(self, contain_fatal: bool = False) -> list[ProgressEvent]:
        """Advance ONE unfinished task (WRR-chosen) by one segment;
        returns the events it streamed (empty when the service is idle
        or the step was spent containing a fault).

        `contain_fatal=True` (the transport server's long-lived loop)
        converts a fatal / retry-exhausted task fault into structured
        ``error`` outcomes for its requests instead of propagating;
        synchronous callers keep the default re-raise."""
        if self._pending:
            self._form_batches()
        self._expire_requests()
        task = self._next_task()
        if task is None:
            return []
        task.checkpoint_hook = self.checkpoint_hook
        seg_spans = self._open_segment_spans(task)
        try:
            events = task.advance(self.fault_hook)
        except _SplitBatch:
            self._close_segment_spans(seg_spans, None, "split")
            self._split(task)
            return []
        except _QuarantineTask as q:
            self._close_segment_spans(seg_spans, None, "quarantine")
            self._quarantine(task, q.record)
            return []
        except Exception as exc:
            self._close_segment_spans(seg_spans, None, "error")
            if not contain_fatal:
                raise
            self._quarantine(task, faults.fault_record(
                exc, faults.classify(exc), task.retry.retries))
            return []
        self._close_segment_spans(seg_spans, events, "ok")
        self._c_segments.inc()
        for ev in events:
            self._events.setdefault(ev.request_id, []).append(ev)
            if ev.best_point is not None:
                self._frontier[ev.request_id] = ev.best_point
        if self._gc is not None and isinstance(task, _BatchTask):
            self._gc.touch(task.task_id)
            self._gc.sweep()
        if task.done:
            for req, out in task.final_outcomes():
                if out.request_id in self._outcomes:
                    continue
                self._finalize(out.request_id, out,
                               count_degraded=True)
                if out.request_id not in self._frontier \
                        and out.result is not None:
                    pt = _point_of(task.workload, req.config, out.result)
                    if pt is not None:
                        self._frontier[out.request_id] = pt
            self._retire(task)
        return events

    def _open_segment_spans(self, task) -> dict[str, int]:
        """One per-segment child span under each live member request's
        root — the batch advances together, so siblings share the
        interval but each tree stays self-contained."""
        spans = {}
        for r in task.requests:
            rid = r.request_id
            if rid in self._outcomes or rid in task.finalized:
                continue
            spans[rid] = self.tracer.start_span(
                "segment", parent_id=self._root_span.get(rid),
                segment=task.seg_done, task_id=task.task_id)
        return spans

    def _close_segment_spans(self, spans: dict[str, int],
                             events: list[ProgressEvent] | None,
                             outcome: str) -> None:
        by_rid = {ev.request_id: ev for ev in (events or [])}
        for rid, sid in spans.items():
            ev = by_rid.get(rid)
            if ev is not None:
                self.tracer.end_span(sid, outcome=outcome,
                                     best_edp=ev.best_edp,
                                     n_evals=ev.n_evals,
                                     improved=ev.improved)
            else:
                self.tracer.end_span(sid, outcome=outcome)

    def _finalize(self, rid: str, out: SearchOutcome,
                  count_degraded: bool = False) -> None:
        """Record an outcome once: registry counters, request-latency
        histogram, and the root span's drain event + close."""
        self._outcomes[rid] = out
        self._c_completed.inc(status=out.status)
        if count_degraded and out.degraded:
            self._c_degraded.inc()
        root = self._root_span.get(rid)
        if root is not None:
            self.tracer.add_event(root, "drain", status=out.status)
            self.tracer.end_span(root, status=out.status)
        t0 = self._submit_t.pop(rid, None)
        if t0 is not None:
            self._h_request.observe(self.cfg.clock_fn() - t0)

    def _retire(self, task) -> None:
        """Garbage-collect a finished task's checkpoints.  (Retry and
        backoff totals are counted at event time by the trace-event
        hook, so there is nothing to fold here any more.)"""
        if self._gc is not None and self.cfg.gc_completed:
            self._gc.remove(task.task_id)

    def _split(self, task) -> None:
        """Poison containment: re-form a multi-request batch as
        singleton tasks.  Siblings replay deterministically from
        scratch — a singleton run is bit-identical to its batch slice,
        so healthy requests still answer exactly; the poison request
        re-fails alone and quarantines without taking anyone with it."""
        self._c_splits.inc()
        self._tasks.remove(task)
        self._retire(task)
        for req in task.requests:
            rid = req.request_id
            root = self._root_span.get(rid)
            if root is not None:
                self.tracer.add_event(root, "split",
                                      task_id=task.task_id)
            if rid in self._outcomes:
                continue
            self._register_task(_BatchTask(self.cfg, task.workload, [req]))
            self._c_batches.inc(kind="fused")

    def _quarantine(self, task, record: dict) -> None:
        """Finalize a poison task with a structured error outcome."""
        task.done = True
        self._retire(task)
        for req in task.requests:
            rid = req.request_id
            if rid in self._outcomes or rid in task.finalized:
                continue
            self._c_quarantined.inc()
            root = self._root_span.get(rid)
            if root is not None:
                self.tracer.add_event(
                    root, "quarantine",
                    fault_class=record.get("fault_class"),
                    type=record.get("type"))
            self._finalize(rid, SearchOutcome(
                request_id=rid, result=None, status="error",
                error=record))

    def drain(self) -> dict[str, SearchOutcome]:
        """Run every pending/in-flight request to completion (normal,
        degraded, timed out, or quarantined)."""
        while self._pending or any(not t.done for t in self._tasks):
            self.step()
        out = dict(self._outcomes)
        for alias, canon in self._aliases.items():
            if canon in self._outcomes:
                out[alias] = self._outcomes[canon]
        return out

    # -- results -----------------------------------------------------------

    def events(self, request_id: str) -> list[ProgressEvent]:
        return list(self._events.get(self._rid(request_id), []))

    def outcome(self, request_id: str) -> SearchOutcome | None:
        return self._outcomes.get(self._rid(request_id))

    def pareto_frontier(self) -> list[tuple]:
        """Non-dominated (request_id, energy, latency) points over every
        request's current best — the service-wide frontier whose deltas
        the event stream carries (`best_point` updates)."""
        pts = [(rid, e, lat)
               for rid, (e, lat) in self._frontier.items()]
        front = []
        for rid, e, lat in pts:
            if not any((e2 <= e and l2 <= lat and (e2 < e or l2 < lat))
                       for _, e2, l2 in pts):
                front.append((rid, e, lat))
        return sorted(front, key=lambda t: t[1])

    def fault_stats(self) -> dict:
        """The serving-runtime fault section a serving benchmark
        publishes — read straight off the metrics registry (the same
        counters `/v1/metrics` exposes), plus checkpoint-GC
        accounting."""
        return {
            "retries": int(self._c_retries.total()),
            "backoff_s": self._c_backoff.total(),
            "quarantined": int(self._c_quarantined.total()),
            "batch_splits": int(self._c_splits.total()),
            "timeouts": int(self._c_timeouts.total()),
            "degraded_requests": int(self._c_degraded.total()),
            "dedup_hits": int(self._c_dedup.total()),
            "checkpoint_gc": None if self._gc is None
            else self._gc.stats(),
        }

    def stats(self) -> dict:
        """Serving health: engine-cache hit/miss/eviction/build-time
        counters, batching composition, the fault/retry section, and a
        telemetry summary — every count is a registry read, so this can
        never disagree with `/v1/metrics`."""
        return {
            "engine_cache": engine_cache_stats(),
            "fleet_engine_cache": fleet_engine_cache_stats(),
            "n_batches": int(self._c_batches.total()),
            "n_grouped_batches": int(self._c_batches.value(
                kind="group")),
            "n_requests_done": len(self._outcomes),
            "n_requests_pending": len(self._pending)
            + sum(1 for t in self._tasks if not t.done
                  for r in t.requests
                  if r.request_id not in self._outcomes),
            "faults": self.fault_stats(),
            "telemetry": {
                "spans": len(self.tracer.spans()),
                "spans_dropped": self.tracer.dropped,
                "history_rows": len(self.history),
                "history_dropped": self.history.dropped,
            },
        }

    # -- observability endpoints -------------------------------------------

    def request_trace(self, request_id: str) -> dict | None:
        """The rooted span tree of one request's lifecycle (submit →
        queue wait → batch join → per-segment advances → drain, fault
        events inline), or None for unknown ids."""
        root = self._root_span.get(self._rid(request_id))
        if root is None:
            return None
        return self.tracer.tree(root)

    def metrics_text(self) -> str:
        """Prometheus text exposition: the service registry (request /
        fault / segment families) merged with the process-global one
        (engine builds, checkpoint IO), plus engine-cache gauges
        refreshed at scrape time."""
        g_rate = self.metrics.gauge("engine_cache_hit_rate",
                                    "engine-cache hit rate", ("cache",))
        g_size = self.metrics.gauge("engine_cache_size",
                                    "live engine-cache entries",
                                    ("cache",))
        g_build = self.metrics.gauge(
            "engine_cache_build_seconds_total",
            "summed engine build time per cache", ("cache",))
        for name, st in (("search", engine_cache_stats()),
                         ("fleet", fleet_engine_cache_stats())):
            g_rate.set(st["hit_rate"], cache=name)
            g_size.set(st["size"], cache=name)
            g_build.set(st["build_seconds_total"], cache=name)
        return _obs.render_prometheus(self.metrics, _obs.get_metrics())

    def save_history(self, path) -> int:
        """Persist the search-history store (npz); returns row count."""
        return self.history.save(path)


def _point_of(workload: Workload, cfg: SearchConfig, res):
    """(energy, latency) of a finished result's best point — the
    fallback frontier entry for requests whose event stream never
    carried one (best never improved past the start points)."""
    mappings = getattr(res, "best_mappings", None)
    if not mappings or not np.isfinite(res.best_edp):
        return None
    cspec = resolve_spec(cfg.spec)
    _, results = evaluate_workload(mappings, workload.layers, spec=cspec)
    energy = sum(r.energy * layer.repeat
                 for r, layer in zip(results, workload.layers))
    latency = sum(r.latency * layer.repeat
                  for r, layer in zip(results, workload.layers))
    return (float(energy), float(latency))
