"""Sharding rules: logical axis names -> mesh PartitionSpecs.  The port
of `repro.sharding.rules`, the same table and functions, held as data.

Mesh axes (`launch.mesh`):
  * "pod"   — data parallelism across pods,
  * "data"  — data parallelism + FSDP/ZeRO within a pod,
  * "model" — tensor/expert parallelism within a pod,
  * "pop"   — co-search population / fleet-member axis.

Parallelism map:
  * batch:       ("pod", "data")
  * TP:          attention heads / d_ff / vocab over "model"
  * FSDP:        parameter d_model (or widest non-TP) dim over "data";
                 optimizer state inherits parameter sharding (ZeRO)
  * EP:          MoE experts over "model"
  * SP:          long-context activations over "data" (sequence dim)

`PartitionSpec` is the port's own: a tuple with one entry per tensor
dim, each None (replicated), a mesh axis name, or a tuple of axis
names, as `jax.sharding.PartitionSpec` holds them.  The dry-run
(`launch.cells`) reads the model specs to divide each leaf's bytes per
device.  Training over several cards places by them: one process a
card over a ("pod", "data", "model") `torch.distributed` device mesh
(`launch.mesh.init_train_mesh`), each parameter and optimizer moment a
DTensor whose `placements` its spec gives (`distribute_tree`), and
`constrain` reshards activations as the reference's
`with_sharding_constraint` does; a model placed so prefills and
decodes there too, the decode step keeping the weights where they are
stored (`stationary_weights`, `weight_product`).  Outside such a mesh
(a plain tensor) `constrain` returns its argument: single-device
prefill, decode and training run the same code and move nothing.

The "pop" axis does place tensors: `shard_map` runs a function once
per member block of a population over a `launch.mesh.DeviceMesh`, one
host thread per shard, each on its shard's device and, on a card, its
own stream (the co-search engines, `core.search` and `core.fleet`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_flatten, tree_unflatten


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name, or a tuple of
    axis names; `PartitionSpec()` is replicated whatever the rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Production mesh axis widths (launch/mesh.py), used at init time to
# pick divisibility-safe parameter shardings.
POD_AXIS_SIZE = 2
DATA_AXIS_SIZE = 16
MODEL_AXIS_SIZE = 16

# logical name -> mesh axes (None = replicated)
LOGICAL_RULES: dict[str | None, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "batch_data": "data",
    "seq": None,
    "seq_sp": "data",          # sequence-parallel variant
    "vocab": "model",
    "embed": "data",           # FSDP shard of d_model
    "embed_tp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "image": None,
    "layers": None,            # stacked leading axis
    None: None,
}


def spec(*logical: str | None) -> PartitionSpec:
    """PartitionSpec from logical axis names, e.g.
    spec("embed", "mlp") -> P("data", "model")."""
    return P(*(LOGICAL_RULES[name] for name in logical))


def batch_spec(extra_dims: int = 1) -> PartitionSpec:
    return P(("pod", "data"), *([None] * extra_dims))


# --- population ("pop") axis specs for the sharded co-search engines.
POP_AXIS = "pop"
LOGICAL_RULES["members"] = POP_AXIS     # population / fleet-member axis


def member_spec(extra_dims: int = 0) -> PartitionSpec:
    """(P, ...) member-leading tensors: theta, orders, SpecParams
    leaves.  `extra_dims` trailing dims stay unsharded."""
    return P(POP_AXIS, *([None] * extra_dims))


def segment_member_spec(extra_dims: int = 0) -> PartitionSpec:
    """(S, P, ...) per-segment stacked outputs of the fused loop: the
    segment axis leads, the member axis is sharded."""
    return P(None, POP_AXIS, *([None] * extra_dims))


class MemberShards:
    """A member-sharded tensor: one block per device of a pop `mesh`,
    each on its device, split along the member `axis` in shard order —
    the port's counterpart of an array placed with a member spec."""

    def __init__(self, blocks, mesh, axis: int = 0):
        self.blocks = tuple(blocks)
        self.mesh = mesh
        self.axis = axis
        if len(self.blocks) != mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a "
                             f"{mesh.size}-device mesh")

    @property
    def shape(self) -> torch.Size:
        sizes = list(self.blocks[0].shape)
        sizes[self.axis] = sum(b.shape[self.axis] for b in self.blocks)
        return torch.Size(sizes)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (the mesh's first device by
        default), blocks concatenated in shard order."""
        dev = self.mesh.devices[0] if device is None else device
        return torch.cat([b.to(dev) for b in self.blocks], dim=self.axis)


def _member_axis(pspec: PartitionSpec | None) -> int | None:
    if pspec is None or POP_AXIS not in pspec:
        return None
    return pspec.index(POP_AXIS)


def shard_tensor(x: torch.Tensor, mesh, pspec: PartitionSpec
                 ) -> MemberShards:
    """Split `x` along the member axis `pspec` names into one block per
    device of `mesh`, each moved to its device."""
    axis = _member_axis(pspec)
    if axis is None:
        raise ValueError(f"{pspec!r} names no {POP_AXIS!r} axis")
    if isinstance(x, MemberShards):
        if x.mesh.devices != mesh.devices or x.axis != axis:
            raise ValueError("the tensor is sharded over another mesh "
                             "or axis")
        return x
    n = mesh.size
    if x.shape[axis] % n:
        raise ValueError(f"{n} shards do not divide the "
                         f"{x.shape[axis]}-member axis evenly")
    return MemberShards([b.to(d) for b, d in zip(x.chunk(n, dim=axis),
                                                 mesh.devices)],
                        mesh, axis)


def _is_spec_leaf(spec) -> bool:
    return spec is None or isinstance(spec, PartitionSpec)


def _rebuild(like, parts):
    return type(like)(*parts) if hasattr(like, "_fields") \
        else type(like)(parts)


def _map_spec(fn, spec, tree):
    """``fn(spec_leaf, subtree)`` over `tree` along `spec`, a pytree
    prefix of it (tuples, lists, NamedTuples, dicts) whose leaves are
    PartitionSpecs or None."""
    if _is_spec_leaf(spec):
        return fn(spec, tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], tree[k]) for k in spec}
    return _rebuild(tree, [_map_spec(fn, s, t) for s, t in zip(spec, tree)])


def _transpose(spec, outs: list):
    """Per-shard output trees -> one tree, down to `spec`'s leaves, of
    per-shard lists."""
    if _is_spec_leaf(spec):
        return list(outs)
    if isinstance(spec, dict):
        return {k: _transpose(spec[k], [o[k] for o in outs]) for k in spec}
    return _rebuild(spec, [_transpose(s, [o[j] for o in outs])
                           for j, s in enumerate(spec)])


def _shard_args(specs, args, mesh) -> list:
    """One argument tuple per shard: member-spec tensors as that
    shard's block, other tensors (spec None) moved to its device."""
    def split(pspec, sub):
        leaves, treedef = tree_flatten(sub)
        axis = _member_axis(pspec)
        per_leaf = []
        for x in leaves:
            if axis is not None:
                per_leaf.append(shard_tensor(x, mesh, pspec).blocks)
            elif isinstance(x, torch.Tensor):
                per_leaf.append([x.to(d) for d in mesh.devices])
            else:
                per_leaf.append([x] * mesh.size)
        return [tree_unflatten([blocks[i] for blocks in per_leaf], treedef)
                for i in range(mesh.size)]
    per = _map_spec(split, specs, args)
    return [_map_spec(lambda _, shards, i=i: shards[i], specs, per)
            for i in range(mesh.size)]


def _gather(spec, outs: list, mesh):
    """The per-shard outputs joined along `spec`: member-spec leaves
    concatenated in shard order on the mesh's first device, None leaves
    as the tuple of per-shard values, for the caller to reduce."""
    def join(pspec, per_shard):
        axis = _member_axis(pspec)
        if axis is None:
            return tuple(per_shard)
        flat = [tree_flatten(t)[0] for t in per_shard]
        leaves = [torch.cat([f[j].to(mesh.devices[0]) for f in flat],
                            dim=axis) for j in range(len(flat[0]))]
        return tree_unflatten(leaves, tree_flatten(per_shard[0])[1])
    return _map_spec(join, spec, _transpose(spec, outs))


def _shard_context(device: torch.device, stream):
    """The worker's placement: its card and its own stream (nothing on
    the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(device))
    ctx.enter_context(torch.cuda.stream(stream))
    return ctx


def _record_stream(tree, stream) -> None:
    """Tell the caching allocator that `stream` uses every tensor of
    `tree`, so no other stream reuses its memory before that work."""
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            x.record_stream(stream)


# (card, shard index) -> the stream that shard's worker runs on, kept so
# that the caching allocator's per-stream pools stay warm across calls.
_SHARD_STREAMS: dict = {}


def run_shards(fn: Callable, devices, shard_args: list) -> list:
    """``fn(*shard_args[i])`` for every shard `i`, concurrently: one
    host thread per shard, each under its device and, on a card, a
    stream of its own that first waits for the caller's work on that
    card (the work that made its inputs).  Joined before it returns:
    the caller's streams then wait for every shard's, and the outputs
    come back in shard order.  The first exception of a worker, in
    shard order, is raised here after every worker has ended."""
    streams = []
    for i, (dev, args) in enumerate(zip(devices, shard_args)):
        if dev.type != "cuda":
            streams.append(None)
            continue
        stream = _SHARD_STREAMS.get((dev, i))
        if stream is None:      # setdefault: one stream if callers race
            stream = _SHARD_STREAMS.setdefault(
                (dev, i), torch.cuda.Stream(device=dev))
        stream.wait_stream(torch.cuda.current_stream(dev))
        _record_stream(args, stream)
        streams.append(stream)

    # every worker waits here until all have started: one thread each
    started = threading.Barrier(len(devices))

    def work(i: int):
        started.wait()
        with _shard_context(devices[i], streams[i]):
            return fn(*shard_args[i])

    with ThreadPoolExecutor(max_workers=len(devices),
                            thread_name_prefix="pop-shard") as pool:
        try:
            futures = [pool.submit(work, i) for i in range(len(devices))]
        except RuntimeError:    # a thread could not start: free the rest
            started.abort()
            raise
    outs = [f.result() for f in futures]
    for dev, stream, out in zip(devices, streams, outs):
        if stream is not None:
            caller = torch.cuda.current_stream(dev)
            caller.wait_stream(stream)
            _record_stream(out, caller)
    return outs


def shard_map(fn: Callable, *, mesh, in_specs: tuple, out_specs):
    """The port's `shard_map` over a 1-D pop `mesh`: the returned
    callable splits each argument along the member axis its spec in
    `in_specs` names (`member_spec`, `segment_member_spec`; a spec
    covers every tensor of its subtree, `None` passes a value to every
    shard unsplit), moves each block to its shard's device, runs `fn`
    once per shard concurrently (`run_shards`) and joins the outputs
    along `out_specs`: member-spec outputs concatenated in shard order
    on the mesh's first device, ``None`` outputs as the tuple of
    per-shard values.  Shards never talk to each other while `fn` runs;
    what a collective would reduce, the caller reduces after the join.
    An argument already split over `mesh` (`MemberShards`) keeps its
    blocks."""
    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        shard_args = _shard_args(tuple(in_specs), args, mesh)
        outs = run_shards(fn, mesh.devices, shard_args)
        return _gather(out_specs, outs, mesh)
    return call


# Activation specs, the reference's six.  Attention uses Ulysses-style
# sequence parallelism over "model" (all-to-all between D-sharded
# projections and S-sharded attention core).
ACT_TOKENS = P(("pod", "data"), None, None)          # (B, S, D)
ACT_TOKENS_TP = P(("pod", "data"), None, "model")    # (B, S, D_tp)
ACT_Q_ULYSSES = P(("pod", "data"), None, "model", None)  # (B,H,S_tp,hd)
ACT_KV_GATHERED = P(("pod", "data"), None, None, None)   # (B,Hkv,S,hd)
ACT_KV_DECODE = P(("pod", "data"), None, "model", None)  # cache: S_tp
ACT_GROUPS = P(("pod", "data"), None, None)          # MoE (G, T, D)
# The port's residual stream between products over a training mesh:
# the sequence sharded over "model" (Megatron-style sequence
# parallelism), where XLA's propagation puts the reference's stream.
# A product takes the stream gathered to `ACT_TOKENS` at its entry, and
# a row-parallel partial sum is reduce-scattered back to this spec.
ACT_TOKENS_SEQ = P(("pod", "data"), "model", None)   # (B, S_tp, D)


# Parallelism mode: "tp" (default: TP/EP over "model") or "dp" (pure
# data parallelism: "model" joins the batch axes; weights replicated
# across it).  The hillclimb flips it for small models whose activation
# collectives dominate under 16-way TP.
_PARALLELISM = "tp"


def set_parallelism(mode: str) -> None:
    global _PARALLELISM
    if mode not in ("tp", "dp"):
        raise ValueError(f"parallelism mode {mode!r} is not 'tp' or 'dp'")
    _PARALLELISM = mode


def _apply_mode(pspec: PartitionSpec) -> PartitionSpec:
    if _PARALLELISM == "tp":
        return pspec
    out = []
    for e in pspec:
        if e == "model":
            out.append(None)
        elif (isinstance(e, (tuple, list)) and "data" in e
              and "model" not in e):
            out.append(tuple(e) + ("model",))
        else:
            out.append(e)
    return P(*out)


def sanitize_spec(pspec: PartitionSpec, axis_names) -> PartitionSpec:
    """Apply the parallelism mode, then drop mesh-axis names not present
    in the active mesh (e.g. "pod" on the single-pod mesh)."""
    out = []
    for entry in _apply_mode(pspec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        else:
            out.append(entry if entry in axis_names else None)
    return P(*out)


# ---------------------------------------------------------------------------
# Training placements: PartitionSpecs over a torch.distributed device mesh
# ---------------------------------------------------------------------------

def placements(pspec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of a sanitized `pspec` over `mesh` (a
    `torch.distributed` DeviceMesh with named dims): ``Shard(d)`` on
    every mesh dim that tensor dim `d`'s entry names, ``Replicate()``
    on the others.  A tuple entry such as ("pod", "data") shards one
    dim over both, major to minor as JAX orders them, which is the mesh
    dims' own order; a tuple out of mesh order raises, as does an axis
    the mesh lacks or names twice."""
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{pspec!r}: the mesh {names} has no "
                                 f"axis {a!r}")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"{pspec!r} names mesh axis {a!r} twice")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"{pspec!r}: {axes} is not in the mesh's "
                             f"axis order {names}")
    return tuple(out)


def mesh_placements(pspec: PartitionSpec, mesh) -> tuple:
    """`placements` of `pspec` after `sanitize_spec` against the mesh's
    axis names (the parallelism mode applied, absent axes dropped)."""
    return placements(sanitize_spec(pspec, set(mesh.mesh_dim_names)), mesh)


def local_range(mesh, placements_, dim: int, size: int) -> tuple[int, int]:
    """(start, stop) of this rank's block of tensor dim `dim`, of
    `size`, under `placements_` over `mesh`: DTensor's chunks
    (`torch.chunk`'s sizes), mesh dim by mesh dim, major to minor."""
    start, n = 0, size
    for i, pl in enumerate(placements_):
        if pl == Shard(dim):
            ways = mesh.size(i)
            per = -(-n // ways)
            c = mesh.get_local_rank(i)
            start += c * per
            n = max(0, min(per, n - c * per))
    return start, start + n


def distribute(x: torch.Tensor, mesh, pspec: PartitionSpec) -> DTensor:
    """`x`, whole on every rank, as a DTensor placed by `pspec` over
    `mesh`: each rank keeps a copy of its own shard (nothing is sent),
    so `x` itself may be freed."""
    pl = mesh_placements(pspec, mesh)
    local = distribute_tensor(x.detach(), mesh, pl,
                              src_data_rank=None).to_local()
    return DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_tree(tree, specs, mesh):
    """`distribute` over a nested dict of tensors beside a congruent
    tree of PartitionSpecs (a spec where the tree has a subtree covers
    all of it).  A leaf that is already a DTensor is redistributed to
    its spec's placements."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs if _is_spec_leaf(specs)
                                   else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, mesh_placements(specs, mesh))
    return distribute(tree, mesh, specs)


def on_mesh(mesh):
    """The context a step runs in over `mesh` (a training step, a
    prefill, a decode step): plain tensors that meet DTensors
    (positions, the step count, the learning rate) count as replicated,
    the same on every rank.  Nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None \
        else implicit_replication()


def batch_ways(mesh) -> int:
    """The ranks a batch is split over on `mesh` (a DeviceMesh): the
    product of its "pod" and "data" dims."""
    return math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                     if n in ("pod", "data"))


def batch_shardable(mesh, global_batch: int) -> bool:
    """Whether a `global_batch`-row batch is split over ("pod", "data")
    on `mesh`, as the reference decides a cell's input specs (the
    batch over the devices that are not "model"); else it is
    replicated, and a decode cache's sequence takes ("data", "model")
    (`LM.cache_specs`)."""
    return global_batch % batch_ways(mesh) == 0


def local_shape(mesh, placements_, shape) -> tuple[int, ...]:
    """This rank's block of a tensor of `shape` under `placements_`
    (`local_range` dim by dim)."""
    return tuple(b - a for a, b in (local_range(mesh, placements_, d, n)
                                    for d, n in enumerate(shape)))


# A decode step (`LM.decode_step` over a mesh) keeps the weights where
# they are stored: see `weight_product`.
_STATIONARY: contextvars.ContextVar = contextvars.ContextVar(
    "stationary_weights", default=False)


@contextlib.contextmanager
def stationary_weights():
    """While active, `weight_product` moves an activation smaller than
    its weight instead of gathering the weight's "data" shards, and
    `layers.embed` looks tokens up in the table's shards."""
    token = _STATIONARY.set(True)
    try:
        yield
    finally:
        _STATIONARY.reset(token)


def weights_stay(x, w) -> bool:
    """Whether a product of activation `x` with stored weight `w` keeps
    the weight in place: a DTensor weight under `stationary_weights`
    with more elements than the activation (a decode step's few tokens;
    not the cross-attention's image embeddings)."""
    return (_STATIONARY.get() and isinstance(w, DTensor)
            and x.numel() < w.numel())


def weight_product(x, w, dtype: torch.dtype):
    """`x @ w` in `dtype` for a stored weight `w` (rows, columns last).

    A plain tensor, or a DTensor weight the product gathers
    (`fsdp_gather`, training and prefill), gives `x @ w.to(dtype)` as
    the reference writes it.  Where the weight stays (`weights_stay`,
    a decode step) its "data" shards are not gathered: on each "data"
    mesh dim that shards the weight's rows the activation's last dim
    is split there instead (its rows gathered: an all-to-all of the
    activation), the product is a partial sum, reduced back to the
    activation's rows (a reduce-scatter); on one that shards its
    columns the activation's rows are gathered, and the output's
    columns go back to rows (an all-to-all).  Either way the output
    has the placements the gathered product gives on the "data" dims,
    and DTensor's on the others, and the bytes moved are the
    activation's, not the weight's."""
    if not weights_stay(x, w):
        return x @ fsdp_gather(w).to(dtype)
    mesh = w.device_mesh
    rows, cols, last = Shard(w.dim() - 2), Shard(w.dim() - 1), \
        Shard(x.dim() - 1)
    x_pl, back = list(x.placements), list(x.placements)
    for i, name in enumerate(mesh.mesh_dim_names):
        if name != "data":
            continue
        if w.placements[i] == rows:
            x_pl[i] = last
        elif w.placements[i] == cols or x_pl[i] == last:
            x_pl[i] = Replicate()
    y = x.redistribute(mesh, x_pl) @ w.to(dtype)
    out_pl = [back[i] if name == "data" else p
              for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                                y.placements))]
    return y.redistribute(mesh, out_pl)


def fsdp_gather(w):
    """A stored parameter as a product takes it: over a training mesh
    its "data" shards (FSDP, ZeRO-3) gathered and its "model" shards
    (tensor parallelism) kept, so DTensor runs the reference's
    column- and row-parallel products; the gather's backward
    reduce-scatters the gradient back to the shards.  A plain tensor
    is returned unchanged."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] == "data" else p
               for i, p in enumerate(w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def even_placements(placements_, shape, mesh) -> tuple:
    """`placements_` of a tensor of `shape` over `mesh`, each mesh dim
    that would split its tensor dim into unequal shards (fewer rows
    than ranks, say) replicated instead, major to minor.  DTensor plans
    the views of a tensor on its even shards only (its local shapes
    are the global ones divided); XLA pads where this replicates."""
    out, left = [], list(shape)
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            if left[pl.dim] % mesh.size(i):
                pl = Replicate()
            else:
                left[pl.dim] //= mesh.size(i)
        out.append(pl)
    return tuple(out)


def constrain(x, pspec: PartitionSpec):
    """The reference's `constrain`: `x` resharded to `pspec` when it is
    a DTensor (a tensor of a training mesh), `x` unchanged otherwise.
    The spec is sanitized against the mesh's axes first (the
    parallelism mode; "pod" dropped on a mesh without it), and a mesh
    dim that does not divide its tensor dim replicates it
    (`even_placements`)."""
    if not isinstance(x, DTensor):
        return x
    pl = even_placements(mesh_placements(pspec, x.device_mesh), x.shape,
                         x.device_mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)
