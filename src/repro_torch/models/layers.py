"""Transformer building blocks of the dense family, on torch: the port
of `repro.models.layers` (norm, RoPE, attention, MLP, embedding).

Functions take a nested dict of tensors (the reference's parameter
tree) and activations.  Parameters live in `param_dtype` and are cast
to `compute_dtype` at use, as in the reference.  One device: the
reference's sharding annotations (`constrain`, `spec`) have no
counterpart here.  Parameter init draws from an explicit
`torch.Generator` on the parameters' device; it gives other numbers
than the reference's `jax.random` keys (`convert.lm_params_from_numpy`
carries the reference's parameters over).

`flash_attention` runs the Hopper flash kernel on CUDA tensors and its
plain version on CPU tensors; where q, k or v needs a gradient it goes
through the kernels' `torch.autograd.Function`
(`kernels.flash_attention.attention`) on either device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.flash_attention import attend, attention
from ..kernels.flash_attention.ref import attention_lse_ref

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None, device=None) -> torch.Tensor:
    """N(0, scale^2) of `shape` on `device` (the generator's unless
    given; ``"meta"`` gives shapes only); `scale` defaults to
    1/sqrt(fan_in), fan_in = shape[-2] (shape[0] for 1-D)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen,
                    device=gen.device if device is None else device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(cfg: ArchConfig, width: int | None = None,
                 device=None) -> dict:
    width = width or cfg.d_model
    return {"scale": torch.ones((width,), dtype=dtype_of(cfg.param_dtype),
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return out.to(dt) * params["scale"].to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention: the Hopper kernels on the card, their plain versions on CPU
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.
    Exact softmax attention; `q_offset` is the absolute position of
    q[0] for causal masking.

    On a CUDA tensor this launches the Hopper flash kernel
    (`kernels.flash_attention.attend`), which tiles by its own tiles;
    on a CPU tensor it runs the kernel's plain version
    (`attention_lse_ref`, the materialized softmax in float32).  Both
    take the reference's shapes: the chunk count max(Sk // chunk, 1) of
    its blockwise loop must divide Sk, as its reshape requires.

    When autograd is on and q, k or v requires a gradient, the call
    goes through `kernels.flash_attention.attention` instead: on the
    card the forward kernel with its log-sum-exp and the backward
    kernel, on the CPU their plain versions.  `attend` alone returns a
    tensor with no gradient, so it never serves such a call."""
    hq, hkv, sk = q.shape[1], k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of KV heads "
                         f"{hkv}")
    n_chunks = max(sk // chunk, 1)
    if sk % n_chunks:
        raise ValueError(f"{n_chunks} chunks do not divide Sk={sk} "
                         f"(chunk={chunk})")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_lse_ref(q, k, v, causal=causal,
                                 q_offset=q_offset)[0]
    return attend(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, q_offset=q_offset)


# ---------------------------------------------------------------------------
# Attention block (self-attention, GQA, qk-norm, biases, rope)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ArchConfig,
                   lead: tuple = (), device=None) -> dict:
    """Attention parameters; `lead` prepends stacking dims (the LM's
    n_periods) to every leaf."""
    pdt = dtype_of(cfg.param_dtype)
    dev = gen.device if device is None else device
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    params = {
        "wq": dense_init(gen, (*lead, d, qd), pdt, device=dev),
        "wk": dense_init(gen, (*lead, d, kvd), pdt, device=dev),
        "wv": dense_init(gen, (*lead, d, kvd), pdt, device=dev),
        "wo": dense_init(gen, (*lead, qd, d), pdt,
                         scale=1.0 / math.sqrt(qd * 2 * cfg.n_layers),
                         device=dev),
    }
    if cfg.qkv_bias:
        params.update(
            bq=torch.zeros((*lead, qd), dtype=pdt, device=dev),
            bk=torch.zeros((*lead, kvd), dtype=pdt, device=dev),
            bv=torch.zeros((*lead, kvd), dtype=pdt, device=dev))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = {"scale": torch.ones(
                (*lead, cfg.head_dim), dtype=pdt, device=dev)}
    return params


def _split_heads(x: torch.Tensor, n_heads: int,
                 head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def attention_qkv(params: dict, cfg: ArchConfig, x: torch.Tensor,
                  kv_x: torch.Tensor, positions: torch.Tensor,
                  kv_positions: torch.Tensor, use_rope: bool = True):
    """Project to (q, k, v) head tensors: (B, H, S, hd)."""
    cdt = dtype_of(cfg.compute_dtype)
    q = x @ params["wq"].to(cdt)
    k = kv_x @ params["wk"].to(cdt)
    v = kv_x @ params["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if use_rope:
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, kv_positions[:, None, :], cfg.rope_theta)
    return q, k, v


def attention_apply(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool | None = None,
                    chunk: int = 1024) -> torch.Tensor:
    """Full self-attention block (no cache): returns (B, S, D).  The
    reference's cross-attention (`kv_x`) waits for the VLM slice."""
    causal = cfg.causal if causal is None else causal
    q, k, v = attention_qkv(params, cfg, x, x, positions, positions)
    out = flash_attention(q, k, v, causal=causal,
                          chunk=min(chunk, k.shape[2]))
    b, h, s, hd = out.shape
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ params["wo"].to(dtype_of(cfg.compute_dtype))


def attention_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     position: int):
    """Single-token decode against a KV cache.
    x: (B, 1, D); cache_k/v: (B, Hkv, S_max, hd); position: int (the
    same position for the whole batch).  Returns (out, cache_k,
    cache_v).

    Unlike the reference, which returns updated copies, this writes the
    new K/V row into `cache_k` and `cache_v` in place (they may be views
    into the LM's stacked cache) and returns them."""
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = attention_qkv(params, cfg, x, x, pos, pos)
    cache_k[:, :, position] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, position] = v[:, :, 0].to(cache_v.dtype)
    s_max = cache_k.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, group, 1, cfg.head_dim)
    # bf16 x bf16 products are exact in f32: the f32 einsum is the
    # reference's preferred_element_type=float32 contraction.
    scores = torch.einsum("bhgqd,bhsd->bhgqs", qg.float(),
                          cache_k.to(cdt).float())
    scores = scores / math.sqrt(cfg.head_dim)
    mask = torch.arange(s_max, device=x.device) <= position
    scores = torch.where(mask, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bhgqd", probs, cache_v.float())
    out = out.reshape(b, 1, cfg.q_dim).to(cdt)
    return out @ params["wo"].to(cdt), cache_k, cache_v


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU / ReLU^2 / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = (),
             device=None) -> dict:
    pdt = dtype_of(cfg.param_dtype)
    dev = gen.device if device is None else device
    d, f = cfg.d_model, cfg.d_ff
    params = {
        "w_up": dense_init(gen, (*lead, d, f), pdt, device=dev),
        "w_down": dense_init(gen, (*lead, f, d), pdt,
                             scale=1.0 / math.sqrt(f * 2 * cfg.n_layers),
                             device=dev)}
    if cfg.activation in ("swiglu", "geglu"):
        params["w_gate"] = dense_init(gen, (*lead, d, f), pdt, device=dev)
    return params


def _activate(name: str, u: torch.Tensor,
              g: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's activations; `jax.nn.gelu` is the tanh form."""
    if name == "swiglu":
        return F.silu(g) * u
    if name == "geglu":
        return F.gelu(g, approximate="tanh") * u
    if name == "relu2":
        return torch.square(F.relu(u))
    return F.gelu(u, approximate="tanh")


def mlp_apply(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    u = x @ params["w_up"].to(cdt)
    g = x @ params["w_gate"].to(cdt) if "w_gate" in params else None
    h = _activate(cfg.activation, u, g)
    return h @ params["w_down"].to(cdt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ArchConfig,
                   device=None) -> dict:
    pdt = dtype_of(cfg.param_dtype)
    return {
        "tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), pdt,
                          scale=1.0, device=device),
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab_size), pdt,
                              device=device),
    }


def embed(params: dict, cfg: ArchConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the token table in the compute type.  The reference
    casts the whole table, then gathers; gathering first gives the same
    values without a copy of the table."""
    return params["tok"][tokens].to(dtype_of(cfg.compute_dtype))


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # logits in f32 for a stable softmax-xent
    return (x @ params["unembed"].to(x.dtype)).float()
