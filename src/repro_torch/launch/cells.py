"""Dry-run cells: (architecture x input shape x mesh) counted on the
meta device.  The port of `repro.launch.cells`.

`run_cell` builds meta-tensor stand-ins for every input (weights,
optimizer state, batch or KV cache: shapes and types, no storage),
runs one train, prefill or decode step on them under
`torch.utils.flop_counter.FlopCounterMode` and `OpBytes` (a dispatch
mode that sums each operation's input and output bytes), and reports
per device:

  * `flops` and `bytes_accessed`: the step's totals divided by the
    mesh's device count.  That is the ideal split; the reference's
    per-device HLO counts include work a partition replicates.
  * `memory`: `argument_size_in_bytes` and `output_size_in_bytes`, each
    leaf's bytes divided dim by dim (ceil) by the mesh axes its
    sanitized PartitionSpec names.  There is no compiler here, so
    `temp_size_in_bytes` and `generated_code_size_in_bytes` are absent.
  * `collectives`: the bytes each device sends through collectives,
    by kind, under the keys of `parse_collective_bytes`, counted by
    `CollectiveCensus` over one meta-device step (a training step, a
    prefill, or a decode step at position `seq_len - 1`) of rank 0 of
    the production mesh, planned by DTensor over a fake process group
    of its 256 or 512 ranks (`launch.mesh.fake_production_mesh`): the
    counterpart of the reference's census of the partitioned HLO.
    `device` picks the plans: ``"cuda"`` NCCL's, ``"cpu"`` gloo's,
    which do every all-to-all as an all-gather and a chunk and file it
    so.  Over a mesh of processes, `measure(..., process_mesh=)`
    counts one real step instead.

The meta steps allocate and launch nothing, on any machine: the
flash kernels are custom ops whose fake kernels give shapes and whose
FLOP formulas count the pairs the kernel computes.  The model's Python
loop runs every period, so the counts cover the whole depth; the
reference's depth-1/depth-2 extrapolation (XLA counts a loop body once)
has no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import re
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_config
from ..configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable
from ..data.pipeline import data_config_for, make_batch_rows
from ..device import DEFAULT_DEVICE, canonical_device
from ..models.lm import LM, build_model, param_specs
from ..obs import telemetry as _obs
from ..sharding.rules import (P, PartitionSpec, batch_shardable,
                              sanitize_spec, set_parallelism)
from ..train.optimizer import OptConfig
from ..train.train_step import (TrainConfig, init_train_state,
                                make_train_step, opt_state_specs,
                                place_batch, rank_rows)
from .mesh import (fake_production_mesh, make_production_mesh, mesh_devices,
                   mesh_name)

DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
               "s8": 1, "u8": 1, "pred": 1, "f64": 8, "s64": 8,
               "u16": 2, "s16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
               "c64": 8, "u64": 8}

# bytes moved on the wire per element, ring algorithms
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}

_HLO_RE = re.compile(
    r"=\s*(?:\()?((?:f|bf|s|u|pred|c)[\w\d]*)\[([\d,]*)\][^)]*?\)?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)\(")


def parse_collective_bytes(hlo_text: str) -> dict[str, float]:
    """Sum per-device collective bytes by op kind from partitioned HLO
    text (kept for the multi-device path, and held to the reference)."""
    out: dict[str, float] = {k: 0.0 for k in COLLECTIVE_FACTOR}
    count = 0
    for m in _HLO_RE.finditer(hlo_text):
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        elems = 1
        for d in dims.split(","):
            if d:
                elems *= int(d)
        nbytes = elems * DTYPE_BYTES.get(dtype, 4)
        out[kind] += nbytes * COLLECTIVE_FACTOR[kind]
        count += 1
    out["n_ops"] = count
    out["total"] = sum(v for k, v in out.items()
                       if k in COLLECTIVE_FACTOR)
    return out


# The collectives DTensor issues, by (namespace, op name), and the HLO
# kind `parse_collective_bytes` files each under: the `_c10d_functional`
# ops, and on NCCL the all-to-all of a shard moved between tensor dims
# (`_dtensor.shard_dim_alltoall`, Ulysses' resharding of q).
_COLLECTIVE_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}


class CollectiveCensus(TorchDispatchMode):
    """While active, counts the collectives DTensor's redistributions
    issue in this process (`_COLLECTIVE_KINDS`), as
    `parse_collective_bytes` counts the partitioned HLO's:
    per kind, each op's output bytes times `COLLECTIVE_FACTOR` (the
    gathered tensor of an all-gather, the scattered block of a
    reduce-scatter, twice the tensor of an all-reduce), plus `n_ops`
    and `total`: bytes per device.  An operation on DTensors is handed
    back (NotImplemented) so that DTensor runs it and the mode sees the
    collectives it turns into.  A gloo group has no all-to-all, so
    DTensor gathers there instead, and the census says so.  `by_shape`
    groups the same bytes by "<kind> <dtype><shape>" of each
    collective's output: [operations, bytes]."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0.0 for k in COLLECTIVE_FACTOR}
        self.n_ops = 0
        self.by_shape: dict[str, list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = _COLLECTIVE_KINDS.get(
            (func.namespace, func._schema.name.split("::")[-1]))
        if kind is not None:
            outs = [t for t in _pytree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            moved = sum(tensor_bytes(t) for t in outs) \
                * COLLECTIVE_FACTOR[kind]
            self.bytes[kind] += moved
            self.n_ops += 1
            key = f"{kind} " + " ".join(
                f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                for t in outs)
            seen = self.by_shape.setdefault(key, [0, 0.0])
            seen[0] += 1
            seen[1] += moved
        return out

    def result(self) -> dict[str, float]:
        """The counts under `parse_collective_bytes`' keys."""
        out = dict(self.bytes)
        out["n_ops"] = self.n_ops
        out["total"] = sum(self.bytes.values())
        return out


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins)
# ---------------------------------------------------------------------------

def batch_struct(cfg: ArchConfig, shape: ShapeConfig,
                 device="meta") -> dict:
    """The batch of a train or prefill step, on `device` (meta: no
    storage; elsewhere uninitialised)."""
    b, s = shape.global_batch, shape.seq_len

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if cfg.modality == "audio":
        return {"frames": empty((b, s, cfg.d_model), torch.bfloat16),
                "labels": empty((b, s), torch.int32)}
    out = {"tokens": empty((b, s), torch.int32)}
    if cfg.modality == "vision+text":
        out["image_embeds"] = empty((b, cfg.n_image_tokens, cfg.d_model),
                                    torch.bfloat16)
    return out


def batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                batch_shardable: bool) -> dict:
    bspec = ("pod", "data") if batch_shardable else None
    if cfg.modality == "audio":
        return {"frames": P(bspec, None, None), "labels": P(bspec, None)}
    out = {"tokens": P(bspec, None)}
    if cfg.modality == "vision+text":
        out["image_embeds"] = P(bspec, None, None)
    return out


def input_specs(arch: str, shape_name: str) -> dict:
    """Public helper: meta tensors for an (arch, shape) cell's inputs
    (decode: the token, the position and the cache)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.mode == "decode":
        model = build_model(cfg, device="meta")
        return {"tokens": torch.empty((shape.global_batch, 1),
                                      dtype=torch.int32, device="meta"),
                "position": torch.empty((), dtype=torch.int32,
                                        device="meta"),
                "cache": model.init_cache(shape.global_batch,
                                          shape.seq_len)}
    return batch_struct(cfg, shape)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements `t` addresses: a dim of stride 0 (a
    broadcast) counts once."""
    n = math.prod(size for size, stride in zip(t.shape, t.stride())
                  if stride != 0)
    return n * t.element_size()


_NO_TRAFFIC = ("empty", "new_empty", "_unsafe_view")


class OpBytes(TorchDispatchMode):
    """While active, sums each dispatched operation's tensor input and
    output bytes (`tensor_bytes`) into `self.total`, and by op name into
    `self.by_op`.  Views (`_unsafe_view` among them) and allocations
    without a write (`empty*`) move nothing and are skipped; an in-place
    op's output counts as a write."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if func.is_view or name.startswith(_NO_TRAFFIC):
            return out
        moved = sum(tensor_bytes(t) for t in _pytree_leaves(
            (args, kwargs or {}, out)) if isinstance(t, torch.Tensor))
        self.total += moved
        self.by_op[name] = self.by_op.get(name, 0) + moved
        return out


@dataclasses.dataclass
class StepCount:
    """One step's counts on one device (no mesh division): FLOPs and
    bytes moved, each in total and by op name, and the step's arguments
    and outputs; `collectives`, a real step's `CollectiveCensus` over a
    training mesh of processes, else None."""
    flops: int
    flops_by_op: dict
    bytes_accessed: int
    bytes_by_op: dict
    args: tuple
    outputs: tuple
    collectives: dict | None = None


def flops_by_op(counter: FlopCounterMode) -> dict[str, int]:
    return {str(op): int(n) for op, n in
            counter.get_flop_counts().get("Global", {}).items()}


def _step_fn(model: LM, mode: str, shape: ShapeConfig,
             tcfg: TrainConfig | None, device):
    """(fn, args): the step of `mode` and its arguments on `device`."""
    if mode == "train":
        step, init_opt = make_train_step(model, tcfg)
        params = model.params
        args = (params, init_opt(tcfg.opt, params),
                batch_struct(model.cfg, shape, device))
        return step, args
    if mode == "prefill":
        return model.prefill, (batch_struct(model.cfg, shape, device),)
    cfg = model.cfg
    args = [model.init_cache(shape.global_batch, shape.seq_len),
            torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device=device), shape.seq_len - 1]
    if cfg.modality == "vision+text":
        args.append(torch.empty(
            (shape.global_batch, cfg.n_image_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=device))
    return model.decode_step, tuple(args)


def count_step(model: LM, mode: str, shape: ShapeConfig,
               tcfg: TrainConfig | None = None) -> StepCount:
    """Run one step of `mode` ("train", "prefill", "decode") of `model`
    at `shape` on the model's device under the counters.  On the meta
    device nothing is allocated or launched.  `tcfg` (train) defaults to
    `TrainConfig(OptConfig())`."""
    tcfg = tcfg or TrainConfig(opt=OptConfig())
    fn, args = _step_fn(model, mode, shape, tcfg, model.device)
    with FlopCounterMode(display=False) as fc, OpBytes() as ob:
        outputs = fn(*args)
    return StepCount(flops=int(fc.get_total_flops()),
                     flops_by_op=flops_by_op(fc),
                     bytes_accessed=ob.total, bytes_by_op=ob.by_op,
                     args=args, outputs=outputs)


def shard_bytes(t, pspec: PartitionSpec, mesh: dict[str, int]) -> int:
    """Bytes of one device's shard of `t` (a tensor, or a Python number
    counted as a 4-byte scalar) under `pspec` on `mesh`: each dim
    divided, rounding up, by the product of the mesh axes its sanitized
    entry names."""
    if not isinstance(t, torch.Tensor):
        return 4
    clean = sanitize_spec(pspec, set(mesh))
    n = 1
    for d, size in enumerate(t.shape):
        entry = clean[d] if d < len(clean) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= -(-size // math.prod(mesh[a] for a in axes))
    return n * t.element_size()


def tree_shard_bytes(tree, specs, mesh: dict[str, int]) -> int:
    """Sum of `shard_bytes` over a tree (nested dicts, lists and tuples)
    of tensors beside a congruent tree of specs; a spec where the tree
    has a subtree applies to all of it; None leaves count nothing."""
    if tree is None:
        return 0
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            return sum(tree_shard_bytes(v, specs, mesh)
                       for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(tree_shard_bytes(v, specs, mesh) for v in tree)
        return shard_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(tree[k], specs[k], mesh) for k in tree)
    return sum(tree_shard_bytes(t, s, mesh) for t, s in zip(tree, specs))


def step_specs(model: LM, mode: str, batch_shardable: bool,
               shape: ShapeConfig) -> tuple:
    """(argument specs, output specs) of `_step_fn`'s step, congruent
    with its arguments and outputs: parameters and optimizer state as
    `param_specs` and `opt_state_specs` say, the batch over ("pod",
    "data") when it divides, the decode cache as `cache_specs`, logits
    and metrics replicated.  The prefill's KV stacks take the decode
    cache's layout (the reference leaves them to the compiler)."""
    cfg = model.cfg
    p_specs = param_specs(cfg)
    b_specs = batch_specs(cfg, shape, batch_shardable)
    if mode == "train":
        o_specs = opt_state_specs(p_specs, cfg.optimizer)
        return (p_specs, o_specs, b_specs), (p_specs, o_specs, P())
    c_specs = model.cache_specs(batch_shardable=batch_shardable)
    if mode == "prefill":
        kv = tuple((c_specs[f"slot{si}"]["k"], c_specs[f"slot{si}"]["v"])
                   for si, slot in enumerate(model.slots)
                   if slot.kind == "attn")
        return (b_specs,), (P(), {"kv": kv, "ssm": P()})
    bspec = ("pod", "data") if batch_shardable else None
    args = [c_specs, P(bspec, None), P()]
    if cfg.modality == "vision+text":
        args.append(P(bspec, None, None))
    return tuple(args), (P(), c_specs)


def memory_per_device(model: LM, mode: str, shape: ShapeConfig,
                      mesh: dict[str, int], batch_shardable: bool,
                      count: StepCount) -> dict:
    """`argument_size_in_bytes` and `output_size_in_bytes` per device.
    The parameters are arguments of every step (for prefill and decode
    the model holds them)."""
    arg_specs, out_specs = step_specs(model, mode, batch_shardable, shape)
    args = tree_shard_bytes(count.args, arg_specs, mesh)
    if mode != "train":
        args += tree_shard_bytes(model.params, param_specs(model.cfg),
                                 mesh)
    return {"argument_size_in_bytes": float(args),
            "output_size_in_bytes": float(tree_shard_bytes(
                count.outputs, out_specs, mesh))}


def cache_bytes(cfg: ArchConfig, shape: ShapeConfig,
                mesh: dict[str, int]) -> int:
    """Bytes of one device's shard of a decode cell's cache on `mesh`
    (`LM.cache_specs`, the batch split where the batch axes divide
    it): what a decode step's census is held below, since it moves
    activations and keeps the cache in place."""
    model = build_model(cfg, device="meta")
    shardable = shape.global_batch % (mesh_devices(mesh)
                                      // mesh["model"]) == 0
    return tree_shard_bytes(model.init_cache(shape.global_batch,
                                             shape.seq_len),
                            model.cache_specs(shardable), mesh)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    mode: str
    ok: bool
    skip_reason: str = ""
    error: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict | None = None
    memory: dict | None = None
    n_params: float = 0.0
    lower_s: float = 0.0
    compile_s: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def train_step_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      tcfg: TrainConfig, seed: int = 0,
                      meta: bool = False) -> tuple:
    """(step, params, opt_state, batch): one training step of `cfg` at
    `shape` over `mesh`, for this process's rank of it.  Over a
    training mesh of processes (`launch.mesh.init_train_mesh`) the
    inputs are real: the model drawn on this rank's device from `seed`
    and placed by its specs, this rank's rows of the pipeline's batch
    `seed`.  With `meta` (a fake mesh, `launch.mesh.
    fake_production_mesh`) the parameters, optimizer state and this
    rank's rows are meta tensors: DTensor plans the step and nothing is
    allocated or sent."""
    dev = torch.device("meta") if meta \
        else canonical_device(mesh.device_type)
    gen = None if meta else torch.Generator(dev).manual_seed(seed)
    model = build_model(cfg, device=dev, mesh=mesh, generator=gen)
    step, _ = make_train_step(model, tcfg, mesh)
    params, opt_state = init_train_state(model, tcfg, mesh)
    start, stop = rank_rows(mesh, shape.global_batch)
    if meta:
        batch = batch_struct(cfg, dataclasses.replace(
            shape, global_batch=stop - start), dev)
    else:
        rows = make_batch_rows(data_config_for(cfg, shape, seed), 0,
                               start, stop)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    return step, params, opt_state, batch


def serve_step_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      seed: int = 0, meta: bool = False) -> tuple:
    """(step, *args): one prefill or decode step (`shape.mode`) of
    `cfg` at `shape` over `mesh`, for this process's rank of it, as the
    reference lowers it with `in_shardings`: the model placed by its
    specs, the batch's rows over ("pod", "data") where those axes
    divide the global batch (this rank's rows) and replicated where
    they do not (`rules.batch_shardable`), a decode step's cache by
    `LM.cache_specs` (`LM.init_cache`, zeros) and its position
    `seq_len - 1`.  Over a mesh of processes the model is drawn from
    `seed` on this rank's device and the tokens, frames and image
    embeddings are the pipeline's batch `seed` (a decode step takes
    each row's first token); with `meta` (a fake mesh) everything is a
    meta tensor and nothing is allocated or sent."""
    dev = torch.device("meta") if meta \
        else canonical_device(mesh.device_type)
    gen = None if meta else torch.Generator(dev).manual_seed(seed)
    model = build_model(cfg, device=dev, mesh=mesh, generator=gen)
    b = shape.global_batch
    shardable = batch_shardable(mesh, b)
    start, stop = rank_rows(mesh, b) if shardable else (0, b)
    if meta:
        batch = batch_struct(cfg, dataclasses.replace(
            shape, global_batch=stop - start), dev)
    else:
        rows = make_batch_rows(data_config_for(cfg, shape, seed), 0,
                               start, stop)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    batch.pop("labels", None)
    if shape.mode == "prefill":
        return model.prefill, place_batch(batch, mesh, shardable)
    placed = place_batch({"tokens": batch["tokens"][:, :1], **{
        k: v for k, v in batch.items() if k == "image_embeds"}}, mesh,
        shardable)
    return (model.decode_step, model.init_cache(b, shape.seq_len),
            placed["tokens"], shape.seq_len - 1, placed.get("image_embeds"))


def census_train_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      tcfg: TrainConfig, seed: int = 0,
                      meta: bool = False,
                      census: CollectiveCensus | None = None) -> dict:
    """`CollectiveCensus` of the training step `train_step_inputs`
    gives (the same arguments), under `parse_collective_bytes`' keys;
    `census` (a fresh one by default) keeps the counts.  Every rank of
    `mesh` must call it."""
    step, *args = train_step_inputs(cfg, shape, mesh, tcfg, seed, meta)
    census = CollectiveCensus() if census is None else census
    with census:
        step(*args)
    return census.result()


def census_serve_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      seed: int = 0, meta: bool = False,
                      census: CollectiveCensus | None = None) -> dict:
    """`CollectiveCensus` of the prefill or decode step
    `serve_step_inputs` gives (the same arguments), under
    `parse_collective_bytes`' keys; `census` as `census_train_step`'s.
    Every rank of `mesh` must call it."""
    step, *args = serve_step_inputs(cfg, shape, mesh, seed, meta)
    census = CollectiveCensus() if census is None else census
    with census:
        step(*args)
    return census.result()


def census_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
                tcfg: TrainConfig, seed: int = 0,
                meta: bool = False,
                census: CollectiveCensus | None = None) -> dict:
    """The census of the step of `shape.mode`: `census_train_step`
    (with `tcfg`) or `census_serve_step`."""
    if shape.mode == "train":
        return census_train_step(cfg, shape, mesh, tcfg, seed, meta,
                                 census)
    return census_serve_step(cfg, shape, mesh, seed, meta, census)


def train_config(train_overrides: dict | None = None) -> TrainConfig:
    """The cells' `TrainConfig`: `OptConfig()` and the overrides."""
    return TrainConfig(**{"opt": OptConfig(), **(train_overrides or {})})


def fake_census(cfg: ArchConfig, shape: ShapeConfig, mesh: dict[str, int],
                tcfg: TrainConfig, device=DEFAULT_DEVICE,
                census: CollectiveCensus | None = None) -> dict:
    """The collective census of one meta step of `shape.mode` (train,
    prefill or decode; `census_step`, into `census` if given) of rank 0
    of a fake process group shaped as `mesh` (`fake_production_mesh`):
    DTensor plans the step with `device`'s collectives (``"cuda"``
    NCCL's, ``"cpu"`` gloo's) and nothing is allocated or sent.  A
    process already in a process group raises a ValueError."""
    with fake_production_mesh(mesh, device) as fake:
        return census_step(cfg, shape, fake, tcfg, meta=True,
                           census=census)


def measure(cfg: ArchConfig, shape: ShapeConfig, mesh: dict[str, int],
            train_overrides: dict | None = None,
            process_mesh=None) -> tuple[StepCount, dict]:
    """(count, memory) of `cfg` at `shape` on `mesh`, traced on the meta
    device: the counter `run_cell` and the card comparison share.  With
    `process_mesh` (a mesh of processes) the count's `collectives` is
    the census of one real step of `shape.mode` there
    (`census_step`)."""
    model = build_model(cfg, device="meta")
    n_dev = mesh_devices(mesh)
    batch_shardable = shape.global_batch % (n_dev // mesh["model"]) == 0
    tcfg = train_config(train_overrides)
    count = count_step(model, shape.mode, shape, tcfg)
    if process_mesh is not None:
        count.collectives = census_step(cfg, shape, process_mesh, tcfg)
    return count, memory_per_device(model, shape.mode, shape, mesh,
                                    batch_shardable, count)


# What a cell's count or census raises where the model or DTensor's
# planning fails on its shapes: `run_cell` and the dry-run's sweep
# record it and go on to the next cell.
CELL_ERRORS = (RuntimeError, ValueError, TypeError, KeyError, IndexError,
               AttributeError, AssertionError)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_overrides: dict | None = None,
             train_overrides: dict | None = None,
             parallelism: str = "tp",
             device=DEFAULT_DEVICE,
             census: CollectiveCensus | None = None) -> CellResult:
    """Count one cell on the production mesh (the reference's skip
    rules, overrides and parallelism mode).  `lower_s` is the meta
    count's seconds on the telemetry clock.  Every counted cell (train,
    prefill or decode) then takes its collective census on a fake
    production mesh of `device`'s type (`fake_production_mesh`;
    ``"cuda"``, NCCL's plans, needs a torch built with CUDA but no
    card): `collectives`, counted into `census` if one is given (its
    `by_shape` then groups them by shape), and its seconds in
    `compile_s` (DTensor's planning over the mesh is the port's
    counterpart of XLA's partitioning).  A census that raises fails the
    cell with its traceback in `error`.  A process already in a process
    group raises a ValueError."""
    set_parallelism(parallelism)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = CellResult(arch=arch, shape=shape_name, mesh=mesh_name(mesh),
                     mode=shape.mode, ok=False)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        res.skip_reason = why
        return res
    if dist.is_initialized():
        raise ValueError("a process group is already up in this "
                         "process; a cell's census runs over a fake one "
                         "of its own")
    res.n_params = float(cfg.n_params())
    tracer = _obs.get_tracer()
    t0 = _obs.default_clock()
    with tracer.span("engine.lower", arch=arch, shape=shape_name):
        count, res.memory = measure(cfg, shape, mesh, train_overrides)
    res.lower_s = _obs.default_clock() - t0
    n_dev = mesh_devices(mesh)
    res.flops = count.flops / n_dev
    res.bytes_accessed = count.bytes_accessed / n_dev
    t1 = _obs.default_clock()
    with tracer.span("engine.compile", arch=arch, shape=shape_name):
        # A census that raises (the model's error, or DTensor's
        # planning) fails the cell with its traceback, and a sweep goes
        # on to the next cell.
        try:
            res.collectives = fake_census(
                cfg, shape, mesh, train_config(train_overrides), device,
                census)
        except CELL_ERRORS as e:
            res.error = f"census: {e!r}\n" + traceback.format_exc()[-3000:]
    res.compile_s = _obs.default_clock() - t1
    if res.error:
        return res
    res.ok = True
    return res


def all_cells():
    from ..configs import ARCH_IDS
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            yield arch, shape_name
