"""Declarative device contracts for the port's fused engines.

The reference (`repro.analysis.contracts`) states three properties of
its jitted engines through jit caches, ``jax.transfer_guard`` and the
lowered StableHLO text.  Eager PyTorch has none of those, so the port
states the same properties through what it does have:

* **no_recompile** — a driver loop reuses one engine, however many
  population sizes and segment lengths it replays.  The port's
  counterpart of a compiled program is an *engine build*: an entry of
  `search._ENGINE_CACHE` or `fleet._FLEET_ENGINE_CACHE`, whose
  `LRUCache.inserts_of` counts its builds.  Any other engine its cache
  builds while the calls run (`LRUCache.build_count`) counts too.
* **transfer_free** — a warm call completes with no host read and no
  cross-device copy; `transfer_free_sharded` proves the same of one
  call sharded over a pop mesh, in every shard's worker thread.  A
  `TorchDispatchMode` recorder sees every aten op the call
  dispatches, autograd's backward included, and flags
  ``_local_scalar_dense`` (``.item()``, ``bool()``, ``float()`` of a
  tensor), ``nonzero`` and the other ops whose output size is data,
  boolean-mask indexing, ``lift_fresh`` (numpy or Python data
  entering) and ``_to_copy``/``copy_`` across devices.  Where CUDA is
  available the same window also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a CUDA call never
  skips either guard.
* **no_f64_constants** — no op of the call reads or writes a float64
  tensor: the engines are float32 end to end.

`trace_fingerprint` (alias `jaxpr_fingerprint`, the reference's name)
hashes the recorded op sequence — each op's name and its tensors'
dtypes and shapes, never a device or an address — so a CPU run and a
card run of one call can be compared.

One hazard stays invisible here: under any dispatch mode autograd
computes the backward of ``prod``/``cumprod`` by its subclass-safe
formula, which never reads back, so the recorder cannot see the zero
count the plain backward reads on the card.  The lint rule TH104
covers it.

Each check returns a `ContractResult`; the ``assert_*`` variants raise
`ContractError` for use directly in tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class ContractError(AssertionError):
    """A device contract did not hold."""


@dataclasses.dataclass
class ContractResult:
    name: str
    passed: bool
    detail: str = ""

    def __bool__(self) -> bool:
        return self.passed

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def check(self) -> "ContractResult":
        if not self.passed:
            raise ContractError(f"{self.name}: {self.detail}")
        return self


# ---------------------------------------------------------------------------
# no_recompile: engine builds
# ---------------------------------------------------------------------------

def _engine_entry(engine) -> tuple:
    """(cache, key) of the engine cache entry holding `engine` (an
    engine object or one of its bound methods)."""
    from ..core import fleet, search

    target = getattr(engine, "__self__", engine)
    for cache in (search._ENGINE_CACHE, fleet._FLEET_ENGINE_CACHE):
        key = cache.key_of(target)
        if key is not None:
            return cache, key
    raise TypeError(
        f"{engine!r} is in no engine cache; pass the engine returned by "
        "make_fused_runner / make_fused_fleet_runner / make_fleet_runner")


def compiled_programs(engine) -> int:
    """Number of builds behind an engine: how many times its engine
    cache built the entry's key (1 unless it was evicted or cleared and
    built again)."""
    cache, key = _engine_entry(engine)
    return cache.inserts_of(key)


def _sync() -> None:
    """Wait for the card's queued work (a no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def no_recompile(engine, calls: Iterable[Callable[[], Any]] = (),
                 expected: int = 1) -> ContractResult:
    """Run ``calls`` (zero-arg thunks invoking ``engine``) and check
    the engine was built exactly ``expected`` time(s) in total, counting
    every other engine its cache built during the calls — varying
    population sizes, segment lengths and request mixes must all reuse
    one engine."""
    cache, key = _engine_entry(engine)
    own0, all0 = cache.inserts_of(key), cache.build_count
    for i, thunk in enumerate(calls):
        try:
            thunk()
            _sync()
        # the checker's job is to REPORT any failure, not to crash
        except Exception as e:  # repro-lint: allow[EX301]
            return ContractResult(
                "no_recompile", False, f"call #{i} raised {e!r}")
    own = cache.inserts_of(key)
    others = cache.build_count - all0 - (own - own0)
    n = own + others
    return ContractResult(
        "no_recompile", n == expected,
        f"engine built {n} time(s) ({others} other engine build(s) "
        f"during the calls), expected {expected}")


def assert_no_recompile(engine, calls: Iterable[Callable[[], Any]] = (),
                        expected: int = 1) -> None:
    no_recompile(engine, calls, expected).check()


# ---------------------------------------------------------------------------
# The dispatch recorder
# ---------------------------------------------------------------------------

# Ops that read a value back to the host or whose output size is data.
_HOST_READ_OPS = frozenset(
    {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
     "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
     "aten.equal"})
# numpy or Python data entering the call (a host-to-device copy on
# the card).
_HOST_DATA_OPS = frozenset(
    {"aten.lift_fresh", "aten.lift_fresh_copy", "aten.lift"})
_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})
# Aliases whose presence depends on requires_grad, not on the program.
_ALIAS_OPS = frozenset({"aten.detach", "aten.alias"})


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _sig(tensors) -> tuple:
    return tuple((str(t.dtype), tuple(t.shape)) for t in tensors)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _host_read(name: str, args, kwargs) -> str | None:
    """Why this op leaves the device, or None (decided before the op
    runs: on the card the sync guard may raise inside it)."""
    if name in _HOST_READ_OPS:
        return name
    if name in _HOST_DATA_OPS:
        return f"{name} (host data entering)"
    if name in _INDEX_OPS and len(args) > 1 and any(
            t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1])):
        return f"{name} with a boolean mask"
    if name == "aten._to_copy" and kwargs.get("device") is not None:
        src, dst = args[0].device, torch.device(kwargs["device"])
        if not _same_device(src, dst):
            return f"{name} {src}->{dst}"
    if name == "aten.copy_" and not _same_device(args[0].device,
                                                 args[1].device):
        return f"{name} {args[1].device}->{args[0].device}"
    return None


class _Recorder(TorchDispatchMode):
    """Records every aten op a call dispatches: its name, its tensors'
    (dtype, shape) in and out, and whether it left the device."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, tuple, tuple]] = []
        self.host_reads: list[str] = []
        self.f64_ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        why = _host_read(name, args, kwargs)
        if why:
            self.host_reads.append(why)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(t.dtype == torch.float64 for t in ins + outs):
            self.f64_ops.append(name)
        self.ops.append((name, _sig(ins), _sig(outs)))
        return out


def _distinct(names: list[str], limit: int = 8) -> str:
    seen = list(dict.fromkeys(names))
    more = f" (+{len(seen) - limit} more)" if len(seen) > limit else ""
    return ", ".join(seen[:limit]) + more


# ---------------------------------------------------------------------------
# transfer_free / no_f64_constants / trace_fingerprint
# ---------------------------------------------------------------------------

def _guarded(call: Callable[[], Any], rec: _Recorder) -> Exception | None:
    """Run ``call()`` under `rec` and, where CUDA is available, under
    ``torch.cuda.set_sync_debug_mode("error")`` (restored in a
    ``finally``), then wait for its device work.  Returns what it
    raised, or None."""
    cuda = torch.cuda.is_available()
    try:
        with rec:
            if cuda:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                call()
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
        if cuda:
            done.synchronize()
    # any failure inside the guard IS the finding being reported
    except Exception as e:  # repro-lint: allow[EX301]
        return e
    return None


def _transfer_verdict(raised: Exception | None, host_reads: list[str],
                      what: str) -> ContractResult:
    if raised is not None:
        reads = f"; host reads: {_distinct(host_reads)}" \
            if host_reads else ""
        return ContractResult(
            "transfer_free", False,
            f"host transfer inside guarded call: {raised!r}{reads}")
    if host_reads:
        return ContractResult(
            "transfer_free", False,
            f"host transfer inside guarded call: {_distinct(host_reads)}")
    guard = " and sync_debug_mode('error')" \
        if torch.cuda.is_available() else ""
    return ContractResult("transfer_free", True,
                          f"{what} completed under the dispatch "
                          f"recorder{guard}")


def transfer_free(fn: Callable,
                  make_args: Callable[[], tuple[Sequence, dict]],
                  warmup: bool = True) -> ContractResult:
    """Prove a warm ``fn`` call stays on its device.

    ``make_args()`` returns ``(args, kwargs)`` with every tensor already
    on the device; it is invoked once per call, as the reference's
    (whose engines donate their inputs), so that building the inputs —
    a host-to-device copy — stays outside the guarded window.  The
    warm-up call (the first use of an engine builds device tables, and
    the caching allocator's first ``cudaMalloc`` may synchronize) runs
    OUTSIDE the guard; the measured call runs under the dispatch
    recorder and, where CUDA is available, under
    ``torch.cuda.set_sync_debug_mode("error")`` (restored in a
    ``finally``).  Any host read or cross-device copy fails it."""
    if warmup:
        args, kwargs = make_args()
        fn(*args, **kwargs)
        _sync()
    args, kwargs = make_args()
    rec = _Recorder()
    raised = _guarded(lambda: fn(*args, **kwargs), rec)
    return _transfer_verdict(raised, rec.host_reads,
                             f"warm call of {len(rec.ops)} ops")


def transfer_free_sharded(fn: Callable, make_args: Callable[[], tuple],
                          mesh, in_specs: tuple, out_specs,
                          warmup: bool = True) -> ContractResult:
    """Prove one warm sharded call stays on its devices: ``fn`` runs
    once per member block of ``make_args()``'s arguments (built outside
    the guarded window, as `transfer_free`'s) through
    `sharding.rules.shard_map` over the pop `mesh`, one worker thread a
    shard.  A dispatch mode holds only in the thread that entered it,
    so each worker records its own shard's ops; the calling thread's
    split and join are recorded too, and the sync guard, which is
    process-wide, covers every thread.  A host read in any shard's run
    before the join fails it — a worker that synchronised would
    serialise the shards.  Give a mesh that repeats one device: on
    distinct cards the split and the join are cross-device copies."""
    import threading

    from ..sharding.rules import shard_map

    def sharded(per_shard: Callable):
        return shard_map(per_shard, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)

    workers: list = []

    def recorded(*blocks):
        rec = _Recorder()
        workers.append((threading.get_ident(), rec))
        with rec:
            return fn(*blocks)

    if warmup:
        sharded(fn)(*make_args())
        _sync()
    call, args = sharded(recorded), make_args()
    rec = _Recorder()
    raised = _guarded(lambda: call(*args), rec)
    reads = rec.host_reads + [r for _, w in workers for r in w.host_reads]
    threads = {t for t, _ in workers} - {threading.get_ident()}
    if raised is None and len(threads) != mesh.size:
        return ContractResult(
            "transfer_free", False,
            f"{mesh.size} shards ran on {len(threads)} worker thread(s)")
    n_ops = len(rec.ops) + sum(len(w.ops) for _, w in workers)
    return _transfer_verdict(
        raised, reads, f"warm sharded call of {n_ops} ops, "
        f"{mesh.size} shards on {len(threads)} worker threads,")


def _record(fn: Callable, *args, **kwargs) -> _Recorder:
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    return rec


def no_f64_constants(fn: Callable, *args, **kwargs) -> ContractResult:
    """Run ``fn`` under the recorder and fail on any op with a float64
    tensor among its inputs or outputs — engine calls are float32 end
    to end, so one float64 tensor means a table or literal leaked in."""
    hits = _record(fn, *args, **kwargs).f64_ops
    return ContractResult(
        "no_f64_constants", not hits,
        "no float64 tensor in any op" if not hits
        else f"float64 leaked into the call: {_distinct(hits)}")


def trace_fingerprint(fn: Callable, *args, **kwargs) -> str:
    """Stable hash of the op sequence ``fn`` dispatches — each op's name
    and its tensors' dtypes and shapes, aliases that depend only on
    requires_grad left out — pinning 'this call runs the same program'
    across refactors and across devices."""
    ops = [op for op in _record(fn, *args, **kwargs).ops
           if op[0] not in _ALIAS_OPS]
    return hashlib.sha256(repr(ops).encode()).hexdigest()[:16]


# The reference's name for the same pin.
jaxpr_fingerprint = trace_fingerprint
