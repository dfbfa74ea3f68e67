"""Language-model assembly on torch: the port of `repro.models.lm` for
every family of the model zoo (dense, MoE, SSM, the Jamba hybrid, the
vision-language model with cross-attention, and the audio encoder).

The reference stacks each slot's parameters over a leading `n_periods`
axis and scans over it; the port keeps that parameter tree (same names,
shapes and types, so `convert.lm_params_from_numpy` carries the
reference's parameters over leaf for leaf) and loops over the periods
in Python.  A period is the smallest repeating block pattern: 1 layer
for homogeneous stacks, 8 for Jamba's attention:Mamba interleave, 5
for the VLM's cross-attention cadence.  Three entry points:

  * `train_loss(batch)` — causal LM loss (or, for the encoder,
    per-position classification of `batch["labels"]`), plus the MoE
    auxiliary loss; differentiable: the parameters require gradients;
    with `cfg.remat` each period is recomputed in the backward pass,
    `jax.checkpoint`'s counterpart,
  * `prefill(batch)` — forward + KV cache build,
  * `decode_step(cache, tokens, position, image_embeds)` — one-token
    serve step against the KV and SSM caches.
The serving entry points run under `torch.no_grad`.

Under a training mesh (`launch.mesh.init_train_mesh`; every family)
each parameter is a DTensor placed by `param_specs` (`LM(..., mesh=)`
draws them leaf by leaf, `init_params_placed`), and `constrain`
reshards the token activations where the reference constrains them.
Between products the residual stream lies sharded by sequence over
"model" (`ACT_TOKENS_SEQ`, where XLA's propagation puts the
reference's), each product taking it gathered at its entry
(`_slot_apply`).  The attention runs Ulysses on local shards
(`layers`), the MoE's experts are sharded over "model" (`moe`), and so
are the SSD's heads (`ssm`); a mesh whose "model" axis cannot split a
config's SSD heads raises where the split is made.  A model placed on
a mesh also prefills and decodes there, on inputs placed by
`train.train_step.place_batch`: prefill's K/V stacks come back in the
decode cache's layout (`cache_specs`), `init_cache` places the cache
the same way, and a decode step keeps the weights and the cache where
they are stored (`sharding.rules.stationary_weights`): each rank
attends over its block of the cache's sequence and steps its SSD
heads, and only activations cross the mesh.

Batches hold `tokens` (B, S), or `frames` (B, S, D) for the audio
encoder (whose front-end is a stub, as in the reference), and
`image_embeds` (B, n_image_tokens, D) for the vision-language model.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..sharding.rules import (ACT_TOKENS, ACT_TOKENS_SEQ, P, PartitionSpec,
                              batch_shardable, constrain, distribute,
                              distribute_tree, even_placements, local_shape,
                              mesh_placements, on_mesh, stationary_weights)
from . import layers as L
from . import moe as M
from . import ssm as S


# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotSpec:
    kind: str          # "attn" | "ssm"
    moe: bool
    cross: bool


def period_layout(cfg: ArchConfig) -> list[SlotSpec]:
    if cfg.family == "ssm":
        period = 1
    elif cfg.family == "hybrid":
        period = cfg.attn_layer_period
    elif cfg.cross_attn_period:
        period = cfg.cross_attn_period
    else:
        period = 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers are not a whole number "
                         f"of periods of {period}")
    slots = []
    for i in range(period):
        kind = "attn" if cfg.is_attn_layer(i) else "ssm"
        slots.append(SlotSpec(kind=kind, moe=cfg.is_moe_layer(i),
                              cross=cfg.is_cross_attn_layer(i)))
    return slots


def _slot_init(gen: torch.Generator, cfg: ArchConfig, slot: SlotSpec,
               n_periods: int, device) -> dict:
    """One slot's parameters, each leaf stacked over `n_periods`: the
    mixer (attention or SSM), the cross-attention of a cross slot, and
    the FFN (MoE or dense) of attention slots and of every hybrid slot."""
    lead = (n_periods,)

    def norm():
        return {"scale": torch.ones((*lead, cfg.d_model),
                                    dtype=L.dtype_of(cfg.param_dtype),
                                    device=device)}

    p = {"ln1": norm()}
    if slot.kind == "attn":
        p["attn"] = L.attention_init(gen, cfg, lead, device=device)
    else:
        p["ssm"] = S.ssm_init(gen, cfg, lead, device=device)
    if slot.cross:
        p["lnx"] = norm()
        p["xattn"] = L.attention_init(gen, cfg, lead, device=device,
                                      cross=True)
    if slot.kind == "attn" or cfg.family == "hybrid":
        p["ln2"] = norm()
        if slot.moe:
            p["moe"] = M.moe_init(gen, cfg, lead, device=device)
        elif cfg.d_ff > 0:
            p["mlp"] = L.mlp_init(gen, cfg, lead, device=device)
    return p


def _slot_specs(cfg: ArchConfig, slot: SlotSpec) -> dict:
    """`_slot_init`'s PartitionSpecs for one period (unstacked)."""
    s = {"ln1": L.rmsnorm_specs()}
    if slot.kind == "attn":
        s["attn"] = L.attention_specs(cfg)
    else:
        s["ssm"] = S.ssm_specs()
    if slot.cross:
        s["lnx"] = L.rmsnorm_specs()
        s["xattn"] = L.attention_specs(cfg)
    if slot.kind == "attn" or cfg.family == "hybrid":
        s["ln2"] = L.rmsnorm_specs()
        if slot.moe:
            s["moe"] = M.moe_specs(cfg)
        elif cfg.d_ff > 0:
            s["mlp"] = L.mlp_specs(cfg)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    """The PartitionSpec tree of `init_params`' leaves, the reference's
    (`repro.models.lm.LM.init`): each block leaf's spec has a leading
    None for its stacked period axis."""
    return {
        "embed": L.embedding_specs(cfg),
        "final_norm": L.rmsnorm_specs(),
        "blocks": {f"slot{si}": _tree_map(lambda sp: P(None, *sp),
                                          _slot_specs(cfg, slot))
                   for si, slot in enumerate(period_layout(cfg))}}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> dict:
    """A parameter tree with the reference's names, shapes and types
    (`repro.models.lm.LM.init`), drawn from `gen` on `device` (the
    generator's unless given)."""
    slots = period_layout(cfg)
    n_periods = cfg.n_layers // len(slots)
    dev = gen.device if device is None else device
    return {
        "embed": L.embedding_init(gen, cfg, device=dev),
        "final_norm": L.rmsnorm_init(cfg, device=dev),
        "blocks": {f"slot{si}": _slot_init(gen, cfg, slot, n_periods, dev)
                   for si, slot in enumerate(slots)}}


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_params_placed(cfg: ArchConfig, gen: torch.Generator, mesh) -> dict:
    """`init_params(cfg, gen)` with every leaf a DTensor on `mesh`,
    placed by `param_specs`.  The leaves are drawn in the single-device
    order from the same generator, so they equal the single-device
    draw, and each is sharded as soon as it is drawn: the whole leaf is
    freed before the next, so the peak is one whole leaf above the
    shards.  A pass on the meta device tells which spec each draw
    takes."""
    drawn: list = []
    with L.placing_drawn(lambda t: drawn.append(t) or t):
        abstract = init_params(cfg, torch.Generator("cpu"), device="meta")
    order = {id(t): i for i, t in enumerate(drawn)}
    paths: list = [None] * len(drawn)
    for path, leaf in _leaves_with_paths(abstract):
        if id(leaf) in order:
            paths[order[id(leaf)]] = path
    specs = param_specs(cfg)
    next_spec = iter([_at(specs, path) for path in paths])
    with L.placing_drawn(lambda t: distribute(t, mesh, next(next_spec))):
        params = init_params(cfg, gen)
    return distribute_tree(params, specs, mesh)


def abstract_params(cfg: ArchConfig) -> dict:
    """`init_params`' tree on the meta device: names, shapes and types
    without storage."""
    return init_params(cfg, torch.Generator("cpu"), device="meta")


def _gathered(h: torch.Tensor, gather: bool) -> torch.Tensor:
    """A norm's output as a product takes it: with `gather` (training
    and prefill) whole over "model" (`ACT_TOKENS`), else (a decode
    step) as it lies."""
    return constrain(h, ACT_TOKENS) if gather else h


def _cross_attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
                     image_embeds, gather: bool = True) -> torch.Tensor:
    """A cross slot's residual branch: the text attends to the image
    embeddings, which sit at position 0 (no RoPE, not causal).  The
    normed stream goes to the products through `_gathered`; the image
    K/V path is `attention_apply`'s."""
    if image_embeds is None:
        raise ValueError(f"{cfg.name}: a cross-attention layer needs image "
                         "embeddings (batch['image_embeds'], or "
                         "decode_step's image_embeds), and none were given")
    hx = _gathered(L.rmsnorm(p["lnx"], x), gather)

    def zeros(n):
        return torch.zeros((x.shape[0], n), dtype=torch.int32,
                           device=x.device)

    return L.attention_apply(p["xattn"], cfg, hx, zeros(x.shape[1]),
                             kv_x=image_embeds,
                             kv_positions=zeros(image_embeds.shape[1]))


def _ffn(p: dict, cfg: ArchConfig, x: torch.Tensor, gather: bool = True):
    """The slot's FFN residual branch: (x, aux) with the MoE's
    load-balance loss, or 0.0 for a dense FFN or none.  The norm runs
    on the stream as it lies, and its output goes to the products
    through `_gathered`."""
    if "moe" not in p and "mlp" not in p:
        return x, 0.0
    h = _gathered(L.rmsnorm(p["ln2"], x), gather)
    if "moe" in p:
        out, aux = M.moe_apply(p["moe"], cfg, h)
        return x + out, aux
    return x + L.mlp_apply(p["mlp"], cfg, h), 0.0


def _slot_apply(p: dict, cfg: ArchConfig, slot: SlotSpec, x: torch.Tensor,
                positions: torch.Tensor, image_embeds, causal: bool,
                kv_out=None):
    """One layer's forward (training / prefill path).  Returns (x, aux).
    When `kv_out` is a (k, v) pair of (B, Hkv, S, hd) buffers, this
    attention layer's K and V are written into them and the kernel
    reads them from there.  Over a mesh the buffers are DTensors in the
    decode cache's layout: K and V are resharded to it (their sequence
    split over the mesh dims that shard it, a local slice) and written
    on each rank's shard, and the kernel reads them as they left the
    projection.

    Over a mesh `x` comes and goes sharded by sequence over "model"
    (`ACT_TOKENS_SEQ`): the norms and residual adds run on those
    shards, each product takes its input gathered whole at its entry
    (`ACT_TOKENS`: one gather for `wq`/`wk`/`wv`, one for the FFN's up
    products; the SSD and the MoE gather at theirs), and each
    row-parallel partial sum is reduce-scattered back to the shards
    (`layers.row_parallel_product`)."""
    h = L.rmsnorm(p["ln1"], x)
    if slot.kind == "attn":
        h = constrain(h, ACT_TOKENS)
        q, k, v = L.attention_qkv(p["attn"], cfg, h, h, positions, positions)
        if isinstance(k, DTensor) and kv_out is not None:
            for buf, t in zip(kv_out, (k, v)):
                buf.to_local().copy_(t.redistribute(
                    buf.device_mesh, buf.placements).to_local())
        elif kv_out is not None:
            kv_out[0].copy_(k)
            kv_out[1].copy_(v)
            k, v = kv_out
        out = L.flash_attention(q, k, v, causal=causal,
                                chunk=min(1024, k.shape[2]))
        x = x + L.row_parallel_product(L.merge_heads(out),
                                       p["attn"]["wo"], h.dtype)
    else:
        x = x + S.ssd_forward(p["ssm"], cfg, h)
    if slot.cross:
        x = x + _cross_attention(p, cfg, x, image_embeds)
    x, aux = _ffn(p, cfg, x)
    return constrain(x, ACT_TOKENS_SEQ), aux


def _period_dtensor(t: DTensor, local: torch.Tensor) -> DTensor:
    """`local`, one period of stacked DTensor `t`'s local tensor (its
    period axis is never sharded), as a DTensor of one period."""
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    shape = t.shape[1:]
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False,
                              shape=shape, stride=stride)


def _period_of(t: torch.Tensor, j: int) -> torch.Tensor:
    """Period `j` of a stacked cache leaf, a view, so writes land in
    the stack (over a mesh, in each rank's shard of it)."""
    if not isinstance(t, DTensor):
        return t[j]
    return _period_dtensor(t, t.to_local()[j])


def _unbind_periods(t: torch.Tensor) -> tuple:
    """A stacked leaf's periods (`t.unbind(0)`).  A DTensor (its period
    axis is never sharded) is unbound on its local tensor and each
    period made a DTensor again, so the backward stacks each rank's
    local gradients with no redistribution planned in between: a whole
    stacked leaf is 7.88 GiB of float32 for Gemma-7B's FFN."""
    if not isinstance(t, DTensor):
        return t.unbind(0)
    return tuple(_period_dtensor(t, u) for u in t.to_local().unbind(0))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _ParamTree(nn.Module):
    """A nested dict of tensors held as module parameters, one
    submodule per inner dict.  Floating-point leaves require gradients
    (training); the serving entry points run under `torch.no_grad`."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(
                    value, requires_grad=value.is_floating_point()))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The LM on one device, or over a training `mesh`.  Parameters come
    from `params` (a tree like `init`'s, e.g. from
    `convert.lm_params_from_numpy`) or else are drawn by `init` from
    `generator` (seed 0 on `device` when none is given).  On the meta
    device the parameters are `abstract_params`: shapes without
    storage, for the dry-run.  With `mesh` (`launch.mesh.
    init_train_mesh`; `device` is this process's device in it) every
    parameter is a DTensor placed by `param_specs`: drawn leaf by leaf
    (`init_params_placed`), or `params` placed (`shard`)."""

    def __init__(self, cfg: ArchConfig, device=DEFAULT_DEVICE,
                 generator: torch.Generator | None = None,
                 params: dict | None = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.slots = period_layout(cfg)
        self.n_periods = cfg.n_layers // len(self.slots)
        self.device = resolve_device(device)
        self.mesh = None
        if params is None and self.device.type == "meta":
            params = abstract_params(cfg)
        elif params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            if mesh is not None:
                self._check_generator(generator)
                params = init_params_placed(cfg, generator, mesh)
                self.mesh = mesh
            else:
                params = self.init(generator)
        self.weights = _ParamTree(params)
        if mesh is not None and self.mesh is None:
            self.shard(mesh)

    def shard(self, mesh) -> None:
        """Place the parameters over the training `mesh` by
        `param_specs` (each a DTensor; each rank keeps its shards and
        the whole tensors go).  A model already on `mesh` is left as it
        is; one on another mesh raises."""
        if self.mesh is mesh:
            return
        if self.mesh is not None:
            raise ValueError("the model is placed over another mesh")
        placed = distribute_tree(self.params, param_specs(self.cfg), mesh)
        self.weights = _ParamTree(placed)
        self.mesh = mesh

    def _check_generator(self, gen: torch.Generator) -> None:
        if resolve_device(gen.device) != self.device:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")

    # ---- init ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """A fresh parameter tree (`init_params`) drawn from `gen`, which
        must be on the model's device."""
        self._check_generator(gen)
        return init_params(self.cfg, gen)

    def abstract_init(self) -> tuple[dict, dict]:
        """(parameter tree on the meta device, its PartitionSpecs),
        allocating nothing: the dry-run's stand-ins for 340B- and
        1T-class configs (the reference's `abstract_init`)."""
        return abstract_params(self.cfg), param_specs(self.cfg)

    def cache_specs(self, batch_shardable: bool = True) -> dict:
        """Decode-cache shardings: KV cache sequence-sharded over
        "model" (context parallelism, any kv-head count); SSM state
        head-sharded over "model".  When the batch is too small to
        cover ("pod", "data") (long_500k, B=1), the sequence dim takes
        ("data", "model") instead and the batch is replicated."""
        bspec = ("pod", "data") if batch_shardable else None
        sspec = "model" if batch_shardable else ("data", "model")
        specs: dict[str, dict[str, PartitionSpec]] = {}
        for si, slot in enumerate(self.slots):
            if slot.kind == "attn":
                kv = P(None, bspec, None, sspec, None)
                specs[f"slot{si}"] = {"k": kv, "v": kv}
            else:
                specs[f"slot{si}"] = {
                    "h": P(None, bspec, "model", None, None)}
        return specs

    @property
    def params(self) -> dict:
        """The parameter tree (nested dict of tensors)."""
        return self.weights.tree()

    # ---- embedding of batch inputs ----------------------------------------
    def _embed_inputs(self, params: dict, batch: dict):
        """(x (B, S, D), image embeddings or None), in the compute type:
        the audio encoder takes `frames` as they are (its front-end is a
        stub), the others embed `tokens`.  Over a mesh x is placed on
        the residual stream's sequence shards (`ACT_TOKENS_SEQ`: each
        rank keeps its block, nothing is sent)."""
        cdt = L.dtype_of(self.cfg.compute_dtype)
        if self.cfg.modality == "audio":
            x = batch["frames"].to(cdt)
        else:
            x = L.embed(params["embed"], self.cfg, batch["tokens"])
        img = batch.get("image_embeds")
        return (constrain(x, ACT_TOKENS_SEQ),
                None if img is None else img.to(cdt))

    # ---- forward over the stack -------------------------------------------
    def _period(self, period: dict, j: int, x: torch.Tensor,
                positions: torch.Tensor, image_embeds, causal: bool,
                kv_stacks=None):
        """Period `j`'s layers; `period` holds each slot's parameters of
        this period (`_periods`).  Returns (x, the period's aux loss)."""
        aux = 0.0
        for si, slot in enumerate(self.slots):
            kv = None
            if kv_stacks is not None and kv_stacks[si] is not None:
                kv = (_period_of(kv_stacks[si][0], j),
                      _period_of(kv_stacks[si][1], j))
            x, a = _slot_apply(period[f"slot{si}"], self.cfg, slot, x,
                               positions, image_embeds, causal, kv)
            aux = aux + a
        return x, aux

    def _periods(self, params: dict) -> list[dict]:
        """Per-period parameter trees.  Each stacked leaf is unbound
        once along its period axis, so the backward pass stacks the
        periods' gradients once; indexing `t[j]` per period would build
        a full-size zero gradient for every period and add them up."""
        unbound = _tree_map(_unbind_periods, params["blocks"])
        return [_tree_map(lambda u: u[j], unbound)
                for j in range(self.n_periods)]

    def _stack(self, params: dict, x: torch.Tensor, positions: torch.Tensor,
               image_embeds, causal: bool, kv_stacks=None,
               remat: bool = False):
        """All layers, period by period; returns (x, the summed aux
        loss).  `kv_stacks`: per slot, a (k, v) pair of (n_periods, B,
        Hkv, S, hd) buffers that collect an attention slot's K and V, or
        None.  `remat`: keep only each period's input for the backward
        pass and run the period again there."""
        aux = 0.0
        for j, period in enumerate(self._periods(params)):
            if remat:
                x, a = checkpoint(self._period, period, j, x, positions,
                                  image_embeds, causal, use_reentrant=False)
            else:
                x, a = self._period(period, j, x, positions, image_embeds,
                                    causal, kv_stacks)
            aux = aux + a
        return x, aux

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[0], x.shape[1]
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    # ---- training loss ----------------------------------------------------
    def train_loss(self, batch: dict, params: dict | None = None):
        """Loss of `batch` on the model's device: next-token NLL of
        `tokens` (B, S), or for the encoder (`cfg.causal` False) the NLL
        of `labels` (B, S) at every position; plus 0.01 * aux / n_layers
        (aux: the MoE load-balance losses summed over layers, 0 without
        a router).  `params` defaults to the model's own (which require
        gradients).  Returns (loss, {"nll", "aux"}), differentiable; with
        `cfg.remat` each period runs again in the backward pass.

        Over a mesh the float32 logits stay sharded over "model" by
        vocabulary (`layers.unembed(vocab_shards=True)`: the table's
        column shards, or, for a vocabulary "model" does not divide,
        the table gathered whole and each rank's block of columns), and
        `layers.vocab_parallel_nll` takes the NLL on those shards: three
        all-reduces of float32 (rows, S) over "model" in the forward,
        none in the backward; the logits never cross the mesh.  On one
        device, or a mesh without a "model" axis, it is `log_softmax`
        and `gather`."""
        cfg = self.cfg
        params = self.params if params is None else params
        x, img = self._embed_inputs(params, batch)
        x, aux = self._stack(params, x, self._positions(x), img, cfg.causal,
                             remat=cfg.remat)
        x = constrain(L.rmsnorm(params["final_norm"], x), ACT_TOKENS)
        logits = L.unembed(params["embed"], cfg, x, vocab_shards=True)
        if cfg.causal:
            targets = batch["tokens"][:, 1:].long()
            logits = logits[:, :-1]
        else:
            targets = batch["labels"].long()
        nll = L.vocab_parallel_nll(logits, targets)
        loss = nll.mean() + 0.01 * aux / max(cfg.n_layers, 1)
        return loss, {"nll": nll.mean(), "aux": aux}

    # ---- prefill ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict):
        """Forward pass building the serve cache.  `batch`: `tokens`
        (B, S) integers (or the encoder's `frames` (B, S, D)) on the
        model's device, and `image_embeds` for the VLM.  Returns
        (last_logits (B, 1, V) float32, cache) with cache["kv"] one
        (k, v) pair per attention slot in slot order, each (n_periods,
        B, Hkv, S, hd) in the compute type, and cache["ssm"] None: as
        in the reference, prefill hands back no SSM state.

        On a model placed over a mesh the batch's tensors are DTensors
        (`train.train_step.place_batch`: the rows over ("pod", "data")
        where the batch axes divide them, else replicated), the step
        runs under `rules.on_mesh`, the logits come back as a DTensor
        sharded over the vocabulary as the product leaves them, and
        the K/V stacks as DTensors placed by `cache_specs` (the
        sequence over "model", or ("data", "model") for a batch that
        is replicated)."""
        cfg = self.cfg
        params = self.params
        self._check_placed(batch.values())
        with on_mesh(self.mesh):
            x, img = self._embed_inputs(params, batch)
            b, s = x.shape[0], x.shape[1]
            shape = (self.n_periods, b, cfg.n_kv_heads, s, cfg.head_dim)
            kv_stacks = [
                (self._empty_cache(shape, x.dtype, "k", si, b),
                 self._empty_cache(shape, x.dtype, "v", si, b))
                if slot.kind == "attn" else None
                for si, slot in enumerate(self.slots)]
            x, _ = self._stack(params, x, self._positions(x), img,
                               cfg.causal, kv_stacks)
            x = constrain(L.rmsnorm(params["final_norm"], x), ACT_TOKENS)
            logits = L.unembed(params["embed"], cfg, x[:, -1:])
        return logits, {"kv": tuple(kv for kv in kv_stacks
                                    if kv is not None), "ssm": None}

    def _check_placed(self, tensors) -> None:
        """A placed model takes DTensors only (a plain tensor would
        count as replicated: every rank the whole batch)."""
        if self.mesh is not None and not all(
                isinstance(t, DTensor) for t in tensors if t is not None):
            raise ValueError("the model is placed over a mesh: place its "
                             "inputs (train.train_step.place_batch, "
                             "LM.init_cache) as DTensors")

    def _empty_cache(self, shape, dtype: torch.dtype, name: str, si: int,
                     batch: int, fill=torch.empty) -> torch.Tensor:
        """A stacked cache leaf of `shape` (`name` of slot `si`): on one
        device `fill`'s tensor on the model's device; over a mesh a
        DTensor placed by `cache_specs` for a `batch`-row batch (a
        mesh dim that does not divide its tensor dim replicates it),
        each rank allocating its own shard only."""
        if self.mesh is None:
            return fill(shape, dtype=dtype, device=self.device)
        specs = self.cache_specs(batch_shardable(self.mesh, batch))
        pl = even_placements(mesh_placements(specs[f"slot{si}"][name],
                                             self.mesh), shape, self.mesh)
        local = fill(local_shape(self.mesh, pl, shape), dtype=dtype,
                     device=self.device)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    # ---- serve cache --------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """Zeroed decode cache: per attention slot a stacked
        (n_periods, B, Hkv, S_max, hd) K/V pair in `dtype`; per SSM slot
        a stacked (n_periods, B, nh, ds, hd) float32 state `h`.  On a
        model placed over a mesh each leaf is a DTensor placed by
        `cache_specs` (`batch_size` decides whether the batch axes
        split the rows), and each rank holds its shard only."""
        cfg = self.cfg
        cache = {}
        for si, slot in enumerate(self.slots):
            if slot.kind == "attn":
                shape = (self.n_periods, batch_size, cfg.n_kv_heads,
                         max_seq, cfg.head_dim)
                cache[f"slot{si}"] = {
                    n: self._empty_cache(shape, dtype, n, si, batch_size,
                                         torch.zeros) for n in ("k", "v")}
            else:
                cache[f"slot{si}"] = {"h": self._empty_cache(
                    (self.n_periods, batch_size, cfg.ssm_heads,
                     cfg.ssm_state, cfg.ssm_head_dim), torch.float32, "h",
                    si, batch_size, torch.zeros)}
        return cache

    # ---- decode step --------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, position: int,
                    image_embeds: torch.Tensor | None = None):
        """tokens: (B, 1) integer; position: int; `image_embeds` (B,
        n_image_tokens, D) for the VLM, whose cross slots recompute their
        K/V from them each step.  Returns (logits (B, 1, V) float32,
        cache).  The cache is updated in place (the reference returns a
        new one) and returned.

        On a model placed over a mesh the tokens and image embeddings
        are DTensors placed as `prefill`'s batch and the cache is
        `init_cache`'s; the step runs under `rules.on_mesh` and
        `rules.stationary_weights`: the weights and the cache stay in
        their shards, each rank writes the new K/V row into its block
        of the sequence if `position` falls there, and the logits come
        back as a DTensor as the product leaves them."""
        cfg = self.cfg
        params = self.params
        cdt = L.dtype_of(cfg.compute_dtype)
        self._check_placed([tokens, image_embeds])
        with on_mesh(self.mesh), stationary_weights():
            x = L.embed(params["embed"], cfg, tokens)
            img = None if image_embeds is None else image_embeds.to(cdt)
            for j, period in enumerate(self._periods(params)):
                for si, slot in enumerate(self.slots):
                    p = period[f"slot{si}"]
                    c = cache[f"slot{si}"]
                    h = L.rmsnorm(p["ln1"], x)
                    if slot.kind == "attn":
                        out, _, _ = L.attention_decode(
                            p["attn"], cfg, h, _period_of(c["k"], j),
                            _period_of(c["v"], j), position)
                    else:
                        hc = _period_of(c["h"], j)
                        out, nh = S.ssd_decode(p["ssm"], cfg, h, hc)
                        if nh is not hc:
                            hc.copy_(nh)
                    x = x + out
                    if slot.cross:
                        x = x + _cross_attention(p, cfg, x, img,
                                                 gather=False)
                    x, _ = _ffn(p, cfg, x, gather=False)
                    x = constrain(x, ACT_TOKENS)
            x = L.rmsnorm(params["final_norm"], x)
            return L.unembed(params["embed"], cfg, x), cache


def build_model(cfg: ArchConfig, device=DEFAULT_DEVICE,
                generator: torch.Generator | None = None,
                params: dict | None = None, mesh=None) -> LM:
    return LM(cfg, device=device, generator=generator, params=params,
              mesh=mesh)
