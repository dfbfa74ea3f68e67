"""Language-model assembly on torch: the port of `repro.models.lm` for
the dense family.

The reference stacks each slot's parameters over a leading `n_periods`
axis and scans over it; the port keeps that parameter tree (same names,
shapes and types, so `convert.lm_params_from_numpy` carries the
reference's parameters over leaf for leaf) and loops over the periods
in Python.  Two serving entry points:

  * `prefill(batch)` — forward + KV cache build,
  * `decode_step(cache, tokens, position)` — one-token serve step.

Only attention slots of the dense family are built here.  MoE, SSM and
cross-attention slots, the audio and vision+text modalities, and
`train_loss` wait for later slices (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import DEFAULT_DEVICE, resolve_device
from . import layers as L

_LATER = "waits for a later slice of the port (ROADMAP queue 1 item 8)"


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


def _check_ported(cfg: ArchConfig, slots: list[SlotSpec]) -> None:
    """Raise `NotImplementedError` for what only later slices build."""
    if cfg.modality != "text":
        raise NotImplementedError(f"{cfg.name}: the {cfg.modality} "
                                  f"modality {_LATER}")
    for slot in slots:
        if slot.kind != "attn" or slot.moe or slot.cross:
            raise NotImplementedError(
                f"{cfg.name}: {slot} (family {cfg.family}) {_LATER}; the "
                "port builds dense attention slots only")


def _slot_init(gen: torch.Generator, cfg: ArchConfig, n_periods: int,
               device) -> dict:
    """One attention slot's parameters, each leaf stacked over
    `n_periods`."""
    lead = (n_periods,)

    def norm():
        return {"scale": torch.ones((*lead, cfg.d_model),
                                    dtype=L.dtype_of(cfg.param_dtype),
                                    device=device)}

    p = {"ln1": norm(),
         "attn": L.attention_init(gen, cfg, lead, device=device),
         "ln2": norm()}
    if cfg.d_ff > 0:
        p["mlp"] = L.mlp_init(gen, cfg, lead, device=device)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device=None) -> dict:
    """A parameter tree with the reference's names, shapes and types
    (`repro.models.lm.LM.init`), drawn from `gen` on `device` (the
    generator's unless given)."""
    slots = period_layout(cfg)
    _check_ported(cfg, slots)
    n_periods = cfg.n_layers // len(slots)
    dev = gen.device if device is None else device
    return {
        "embed": L.embedding_init(gen, cfg, device=dev),
        "final_norm": L.rmsnorm_init(cfg, device=dev),
        "blocks": {f"slot{si}": _slot_init(gen, cfg, n_periods, dev)
                   for si in range(len(slots))}}


def abstract_params(cfg: ArchConfig) -> dict:
    """`init_params`' tree on the meta device: names, shapes and types
    without storage."""
    return init_params(cfg, torch.Generator("cpu"), device="meta")


def _slot_apply(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, causal: bool, kv_out=None):
    """One attention layer's forward (prefill path).  When `kv_out` is
    a (k, v) pair of (B, Hkv, S, hd) buffers, this layer's K and V are
    written into them and the kernel reads them from there."""
    h = L.rmsnorm(p["ln1"], x)
    q, k, v = L.attention_qkv(p["attn"], cfg, h, h, positions, positions)
    if kv_out is not None:
        kv_out[0].copy_(k)
        kv_out[1].copy_(v)
        k, v = kv_out
    out = L.flash_attention(q, k, v, causal=causal,
                            chunk=min(1024, k.shape[2]))
    bs, hh, ss, hd = out.shape
    out = out.transpose(1, 2).reshape(bs, ss, hh * hd)
    x = x + out @ p["attn"]["wo"].to(h.dtype)
    if "mlp" in p:
        x = x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["ln2"], x))
    return x


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _ParamTree(nn.Module):
    """A nested dict of tensors held as module parameters (no
    gradients: the serving path), one submodule per inner dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The dense LM on one device.  Parameters come from `params` (a
    tree like `init`'s, e.g. from `convert.lm_params_from_numpy`) or
    else are drawn by `init` from `generator` (seed 0 on `device` when
    none is given)."""

    def __init__(self, cfg: ArchConfig, device=DEFAULT_DEVICE,
                 generator: torch.Generator | None = None,
                 params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.slots = period_layout(cfg)
        _check_ported(cfg, self.slots)
        self.n_periods = cfg.n_layers // len(self.slots)
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = self.init(generator)
        self.weights = _ParamTree(params)

    # ---- init ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        """A fresh parameter tree (`init_params`) drawn from `gen`, which
        must be on the model's device."""
        if resolve_device(gen.device) != self.device:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return init_params(self.cfg, gen)

    @property
    def params(self) -> dict:
        """The parameter tree (nested dict of tensors)."""
        return self.weights.tree()

    # ---- embedding of batch inputs ----------------------------------------
    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        if "image_embeds" in batch:
            raise NotImplementedError(f"image embeddings {_LATER}")
        return L.embed(params["embed"], self.cfg, batch["tokens"])

    # ---- forward over the stack -------------------------------------------
    def _stack(self, params: dict, x: torch.Tensor, positions: torch.Tensor,
               causal: bool, kv_stacks=None) -> torch.Tensor:
        """All layers, period by period.  `kv_stacks`: per attention
        slot a (k, v) pair of (n_periods, B, Hkv, S, hd) buffers that
        collect each layer's K and V."""
        for j in range(self.n_periods):
            for si in range(len(self.slots)):
                p = _tree_map(lambda t: t[j], params["blocks"][f"slot{si}"])
                kv = None
                if kv_stacks is not None:
                    kv = (kv_stacks[si][0][j], kv_stacks[si][1][j])
                x = _slot_apply(p, self.cfg, x, positions, causal, kv)
        return x

    # ---- prefill ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: dict):
        """Forward pass building the serve cache.  `batch["tokens"]`:
        (B, S) integer tokens on the model's device.  Returns
        (last_logits (B, 1, V) float32, cache) with cache["kv"] one
        (k, v) pair per attention slot, each (n_periods, B, Hkv, S, hd)
        in the compute type."""
        cfg = self.cfg
        params = self.params
        x = self._embed_inputs(params, batch)
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        shape = (self.n_periods, b, cfg.n_kv_heads, s, cfg.head_dim)
        kv_stacks = tuple(
            (torch.empty(shape, dtype=x.dtype, device=x.device),
             torch.empty(shape, dtype=x.dtype, device=x.device))
            for _ in self.slots)
        x = self._stack(params, x, positions, cfg.causal, kv_stacks)
        x = L.rmsnorm(params["final_norm"], x)
        logits = L.unembed(params["embed"], cfg, x[:, -1:])
        return logits, {"kv": kv_stacks, "ssm": None}

    # ---- serve cache --------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """Zeroed decode cache: per attention slot a stacked
        (n_periods, B, Hkv, S_max, hd) K/V pair."""
        cfg = self.cfg
        shape = (self.n_periods, batch_size, cfg.n_kv_heads, max_seq,
                 cfg.head_dim)
        return {f"slot{si}": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            for si in range(len(self.slots))}

    # ---- decode step --------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, position: int):
        """tokens: (B, 1) integer; position: int.  Returns (logits
        (B, 1, V) float32, cache).  The cache is updated in place (the
        reference returns a new one) and returned."""
        cfg = self.cfg
        params = self.params
        x = L.embed(params["embed"], cfg, tokens)
        for j in range(self.n_periods):
            for si in range(len(self.slots)):
                p = _tree_map(lambda t: t[j], params["blocks"][f"slot{si}"])
                c = cache[f"slot{si}"]
                h = L.rmsnorm(p["ln1"], x)
                out, _, _ = L.attention_decode(p["attn"], cfg, h, c["k"][j],
                                               c["v"][j], position)
                x = x + out
                if "mlp" in p:
                    x = x + L.mlp_apply(p["mlp"], cfg,
                                        L.rmsnorm(p["ln2"], x))
        x = L.rmsnorm(params["final_norm"], x)
        return L.unembed(params["embed"], cfg, x), cache


def build_model(cfg: ArchConfig, device=DEFAULT_DEVICE,
                generator: torch.Generator | None = None,
                params: dict | None = None) -> LM:
    return LM(cfg, device=device, generator=generator, params=params)
