"""Transformer building blocks on torch: the port of
`repro.models.layers` (norm, RoPE, self- and cross-attention, MLP,
embedding).

Functions take a nested dict of tensors (the reference's parameter
tree) and activations.  Parameters live in `param_dtype` and are cast
to `compute_dtype` at use, as in the reference.  Beside each init, a
`*_specs` function gives the reference's PartitionSpec tree for the
same leaves (`sharding.rules`): the dry-run reads them to divide the
bytes per device, and training over several cards places each leaf by
them.  The reference's activation constraints are kept where it puts
them (`sharding.rules.constrain`): they reshard a DTensor and return a
plain tensor unchanged, so the model runs the same code on one device.
Parameter init draws from an explicit `torch.Generator` on the
parameters' device; it gives other numbers than the reference's
`jax.random` keys (`convert.lm_params_from_numpy` carries the
reference's parameters over).

`flash_attention` runs the Hopper flash kernel on CUDA tensors and its
plain version on CPU tensors; where q, k or v needs a gradient it goes
through the kernels' `torch.autograd.Function`
(`kernels.flash_attention.attention`) on either device.  On DTensors
(a training mesh) it runs the same on each rank's local shards under
`local_map`: q sequence-sharded over "model" (Ulysses), K and V whole,
the output moved to column shards for `wo` by one all-to-all.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..kernels.flash_attention.flash_attention import (attend, attention,
                                                      flash_fwd)
from ..sharding.rules import (ACT_KV_GATHERED, ACT_Q_ULYSSES, ACT_TOKENS,
                              ACT_TOKENS_SEQ, MODEL_AXIS_SIZE, P, constrain,
                              local_range, spec, weight_product,
                              weights_stay)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------

_PLACE_DRAWN: contextvars.ContextVar = contextvars.ContextVar(
    "place_drawn", default=None)


@contextlib.contextmanager
def placing_drawn(place: Callable[[torch.Tensor], torch.Tensor]):
    """While active, every `dense_init` hands its drawn leaf to `place`
    and returns what `place` returns, so a caller can shard each leaf
    (and free the whole one) before the next is drawn."""
    token = _PLACE_DRAWN.set(place)
    try:
        yield
    finally:
        _PLACE_DRAWN.reset(token)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float | None = None, device=None) -> torch.Tensor:
    """N(0, scale^2) of `shape` on `device` (the generator's unless
    given; ``"meta"`` gives shapes only); `scale` defaults to
    1/sqrt(fan_in), fan_in = shape[-2] (shape[0] for 1-D).  Under
    `placing_drawn` the leaf goes through its `place`."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen,
                    device=gen.device if device is None else device)
    x = (x * scale).to(dtype)
    place = _PLACE_DRAWN.get()
    return x if place is None else place(x)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(cfg: ArchConfig, width: int | None = None,
                 device=None) -> dict:
    width = width or cfg.d_model
    return {"scale": torch.ones((width,), dtype=dtype_of(cfg.param_dtype),
                                device=device)}


def rmsnorm_specs() -> dict:
    return {"scale": spec(None)}


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
    (`attention_lse_ref`, the materialized softmax in float32); on a
    meta tensor it gives the output's shape.  All three go through the
    custom op `repro_torch::flash_fwd`, which the FLOP counter counts
    by the kernel's formula.  All take the reference's shapes: the
    chunk count max(Sk // chunk, 1) of its blockwise loop must divide
    Sk, as its reshape requires.

    When autograd is on and q, k or v requires a gradient, the call
    goes through `kernels.flash_attention.attention` instead: on the
    card the forward kernel with its log-sum-exp and the backward
    kernel, on the CPU their plain versions.  `attend` alone returns a
    tensor with no gradient, so it never serves such a call."""
    if isinstance(q, DTensor):
        return _local_flash_attention(q, k, v, causal=causal, chunk=chunk,
                                      q_offset=q_offset)
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
        return flash_fwd(q, k, v, causal, q_offset, False)[0]
    return attend(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, q_offset=q_offset)


def _local_flash_attention(q, k, v, *, causal: bool, chunk: int,
                           q_offset: int):
    """`flash_attention` on DTensors: each rank runs it on its local
    shards (`local_map`) and the output keeps q's placements.  q may be
    sharded over the batch (dim 0) and the sequence (dim 2), k and v
    over the batch only, alike.  A rank's first query row (its
    `local_range` start) joins `q_offset`, so the causal mask sees
    global positions.  Each rank's dK and dV cover its own query rows only, so
    their gradients are declared ``Partial`` over the mesh dims that
    shard q's sequence: DTensor sums them there."""
    mesh = q.device_mesh
    q_pl, kv_pl = tuple(q.placements), tuple(k.placements)
    if tuple(v.placements) != kv_pl:
        raise ValueError(f"k placed {kv_pl}, v {tuple(v.placements)}")
    for pq, pk in zip(q_pl, kv_pl):
        if pq not in (Replicate(), Shard(0), Shard(2)) \
                or pk not in (Replicate(), Shard(0)) \
                or (pq == Shard(0)) != (pk == Shard(0)):
            raise ValueError(f"attention on local shards takes q over the "
                             f"batch and sequence and k, v over the batch "
                             f"alike; got q {q_pl}, k and v {kv_pl}")
    kv_grad = tuple(Partial() if pq == Shard(2) else pk
                    for pq, pk in zip(q_pl, kv_pl))
    offset = q_offset + local_range(mesh, q_pl, 2, q.shape[2])[0]

    def core(ql, kl, vl):
        return flash_attention(ql, kl, vl, causal=causal, chunk=chunk,
                               q_offset=offset)

    return local_map(core, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


# ---------------------------------------------------------------------------
# Attention block (self / cross, GQA, qk-norm, biases, rope)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, cfg: ArchConfig,
                   lead: tuple = (), device=None,
                   cross: bool = False) -> dict:
    """Attention parameters; `lead` prepends stacking dims (the LM's
    n_periods) to every leaf.  `cross` changes nothing: a
    cross-attention block has the same tree, and the flag is there for
    the reference's signature only."""
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


def attention_specs(cfg: ArchConfig) -> dict:
    """`attention_init`'s specs (self or cross: the same tree).  Flat
    projection dims sharded over "model" (divisible for any head count),
    FSDP over "data" on the other dim."""
    specs = {"wq": spec("embed", "embed_tp"), "wk": spec("embed", "embed_tp"),
             "wv": spec("embed", "embed_tp"), "wo": spec("embed_tp", "embed")}
    if cfg.qkv_bias:
        specs.update(bq=spec("heads"), bk=spec("kv_heads"),
                     bv=spec("kv_heads"))
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_specs()
        specs["k_norm"] = rmsnorm_specs()
    return specs


def _split_heads(x: torch.Tensor, n_heads: int,
                 head_dim: int) -> torch.Tensor:
    """(B, S, H * hd) -> (B, H, S, hd).  A DTensor whose last dim is
    sharded over more ways than `n_heads` divides by is gathered there
    first, so that every shard holds whole heads."""
    b, s, _ = x.shape
    if isinstance(x, DTensor):
        ways = math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements)
                         if p == Shard(x.dim() - 1))
        if n_heads % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == Shard(x.dim() - 1) else p
                for p in x.placements])
    return x.reshape(b, s, n_heads, head_dim).transpose(1, 2)


def merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) attention output -> (B, S, H * hd).  Over a
    training mesh the rows Ulysses split over "model" go to column
    shards (`ACT_TOKENS_TP`) by one all-to-all (`_rows_to_columns`), so
    the output projection runs row-parallel on them and
    `row_parallel_product` reduce-scatters its partial sum back to the
    stream's sequence shards.  A sequence "model" does not split (a
    decode step's one row) is constrained to `ACT_TOKENS`."""
    b, h, s, hd = out.shape
    x = out.transpose(1, 2).reshape(b, s, h * hd)
    if isinstance(x, DTensor) and Shard(1) in x.placements:
        return _rows_to_columns(x)
    return constrain(x, ACT_TOKENS)


def _rows_to_columns(x: DTensor) -> DTensor:
    """`x` (B, S, C), its S sharded over one mesh dim, as (B, S, C) with
    C sharded there instead: one all-to-all of each rank's block on
    its local tensor (`local_map`), whose backward is the all-to-all
    back.  It moves each rank's block once, on gloo as on NCCL (where
    DTensor's own redistribution would gather the whole tensor on
    gloo)."""
    mesh = x.device_mesh
    x_pl = tuple(x.placements)
    (i,) = [i for i, p in enumerate(x_pl) if p == Shard(1)]
    n = mesh.size(i)
    if x.shape[2] % n:
        raise ValueError(f"{x.shape[2]} columns do not split over {n} "
                         f"ranks of mesh dim {mesh.mesh_dim_names[i]!r}")
    out_pl = tuple(Shard(2) if j == i else p for j, p in enumerate(x_pl))

    def core(xl):
        b, s, c = xl.shape
        parts = xl.reshape(b, s, n, c // n).permute(2, 0, 1, 3).contiguous()
        got = funcol.all_to_all_single_autograd(parts, None, None,
                                                (mesh, i))
        return got.reshape(n, b, s, c // n).transpose(0, 1).reshape(
            b, n * s, c // n)

    return local_map(core, out_placements=(out_pl,), in_placements=(x_pl,),
                     device_mesh=mesh)(x)


def attention_qkv(params: dict, cfg: ArchConfig, x: torch.Tensor,
                  kv_x: torch.Tensor, positions: torch.Tensor,
                  kv_positions: torch.Tensor, use_rope: bool = True):
    """Project to (q, k, v) head tensors: (B, H, S, hd)."""
    cdt = dtype_of(cfg.compute_dtype)
    q = weight_product(x, params["wq"], cdt)
    k = weight_product(kv_x, params["wk"], cdt)
    v = weight_product(kv_x, params["wv"], cdt)
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
    # Ulysses resharding: q sequence-sharded over "model", K/V gathered.
    q = constrain(q, ACT_Q_ULYSSES)
    k = constrain(k, ACT_KV_GATHERED)
    v = constrain(v, ACT_KV_GATHERED)
    return q, k, v


def attention_apply(params: dict, cfg: ArchConfig, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv_x: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    causal: bool | None = None,
                    chunk: int = 1024) -> torch.Tensor:
    """Full attention block (no cache): returns (B, S, D).  With `kv_x`
    (B, Sk, D) it is cross-attention: keys and values come from `kv_x`,
    no RoPE, never causal."""
    causal = cfg.causal if causal is None else causal
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = attention_qkv(params, cfg, x, kv_x, positions, kv_positions,
                            use_rope=not cross)
    out = flash_attention(q, k, v, causal=causal and not cross,
                          chunk=min(chunk, k.shape[2]))
    return row_parallel_product(merge_heads(out), params["wo"],
                                dtype_of(cfg.compute_dtype))


def attention_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     position: int):
    """Single-token decode against a KV cache.
    x: (B, 1, D); cache_k/v: (B, Hkv, S_max, hd); position: int (the
    same position for the whole batch).  Returns (out, cache_k,
    cache_v).

    Unlike the reference, which returns updated copies, this writes the
    new K/V row into `cache_k` and `cache_v` in place (they may be views
    into the LM's stacked cache) and returns them.  Over a mesh (the
    cache DTensors placed by `LM.cache_specs`) each rank attends over
    its own block of the cache (`_decode_on_mesh`)."""
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = attention_qkv(params, cfg, x, x, pos, pos)
    if isinstance(cache_k, DTensor):
        out = _decode_on_mesh(cfg, q, k, v, cache_k, cache_v, position)
        return weight_product(out, params["wo"], cdt), cache_k, cache_v
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
    return weight_product(out, params["wo"], cdt), cache_k, cache_v


def _decode_on_mesh(cfg: ArchConfig, q, k, v, cache_k: DTensor,
                    cache_v: DTensor, position: int) -> DTensor:
    """`attention_decode`'s core on each rank's block of the cache
    (`local_map`): the cache's sequence is sharded over "model" (or
    ("data", "model") for a batch the batch axes do not divide) and
    stays there.  A rank writes the new K/V row only where `position`
    falls in its block (`local_range`), scores its block against the
    query with the mask on global positions, and the blocks are merged
    by log-sum-exp: the scores' maximum all-reduced over the mesh dims
    that shard the sequence, then each block's sum of exp(s - max) and
    its P.V in one all-reduce.  What crosses the mesh is O(B H hd) a
    layer; no collective holds the cache's sequence dim.  Returns
    (B, 1, Hq * hd) in the compute type, replicated over those dims."""
    cdt = dtype_of(cfg.compute_dtype)
    mesh = cache_k.device_mesh
    c_pl = tuple(cache_k.placements)
    seq = [i for i, p in enumerate(c_pl) if p == Shard(2)]
    row_pl = tuple(Replicate() if p == Shard(2) else p for p in c_pl)
    s0, s1 = local_range(mesh, c_pl, 2, cache_k.shape[2])
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    group = cfg.n_heads // hkv

    def all_reduce(t, op):
        for i in seq:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    def core(ql, kl, vl, ckl, cvl):
        if s0 <= position < s1:
            ckl[:, :, position - s0] = kl[:, :, 0].to(ckl.dtype)
            cvl[:, :, position - s0] = vl[:, :, 0].to(cvl.dtype)
        bl = ql.shape[0]
        qg = ql.reshape(bl, hkv, group, 1, hd)
        scores = torch.einsum("bhgqd,bhsd->bhgqs", qg.float(),
                              ckl.to(cdt).float()) / math.sqrt(hd)
        mask = torch.arange(s0, s1, device=ckl.device) <= position
        scores = torch.where(mask, scores, -torch.inf)
        m = all_reduce(scores.amax(-1, keepdim=True), "max")
        p = torch.exp(scores - m)
        merged = all_reduce(torch.cat(
            [torch.einsum("bhgqs,bhsd->bhgqd", p, cvl.float()),
             p.sum(-1)[..., None]], dim=-1), "sum")
        out = merged[..., :hd] / merged[..., hd:]
        return out.reshape(bl, 1, hkv * group * hd).to(cdt)

    return local_map(core, out_placements=(row_pl,),
                     in_placements=(row_pl,) * 3 + (c_pl, c_pl),
                     device_mesh=mesh)(
        q.redistribute(mesh, row_pl), k.redistribute(mesh, row_pl),
        v.redistribute(mesh, row_pl), cache_k, cache_v)


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


def mlp_specs(cfg: ArchConfig) -> dict:
    specs = {"w_up": spec("embed", "mlp"), "w_down": spec("mlp", "embed")}
    if cfg.activation in ("swiglu", "geglu"):
        specs["w_gate"] = spec("embed", "mlp")
    return specs


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
    u = weight_product(x, params["w_up"], cdt)
    g = weight_product(x, params["w_gate"], cdt) if "w_gate" in params \
        else None
    h = _activate(cfg.activation, u, g)
    return row_parallel_product(h, params["w_down"], cdt)


def row_parallel_product(x: torch.Tensor, w: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """`weight_product` of a row-parallel weight (`wo`, `w_down`: rows
    sharded over "model"), its output constrained to `ACT_TOKENS_SEQ`:
    over a mesh the partial sum over "model" is reduce-scattered to the
    residual stream's sequence shards here, at the product and in
    `dtype` (the compute type), as XLA reduces it.  Left ``Partial``,
    it would flow through the residual add into the next norm, where
    DTensor may reduce it in float32 inside `x.float()`, by torch
    version.  Where the weights stay (a decode step) the product moves
    rows only and is left as it was; a plain tensor is the product
    alone."""
    y = weight_product(x, w, dtype)
    return y if weights_stay(x, w) else constrain(y, ACT_TOKENS_SEQ)


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


def embedding_specs(cfg: ArchConfig) -> dict:
    if cfg.vocab_size % MODEL_AXIS_SIZE == 0:
        return {"tok": spec("vocab", "embed"),
                "unembed": spec("embed", "vocab")}
    # odd vocabularies (50280, 504): shard d_model over the full
    # (data, model) plane instead
    return {"tok": P(None, ("data", "model")),
            "unembed": P(("data", "model"), None)}


def embed(params: dict, cfg: ArchConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the token table in the compute type.  The reference
    casts the whole table, then gathers; gathering first gives the same
    values without a copy of the table.  Over a training mesh the table
    is gathered whole first (`constrain` to `P()`): DTensor's
    vocab-parallel lookup leaves a masked partial sum whose backward
    does not meet the residual stream's partial-sum gradient, and
    indexing's backward has no plan over a mesh in every torch version,
    so the lookup is `F.embedding` on the whole table and its gradient
    is reduce-scattered back to the shards.  Where the weights stay (a
    decode step, `rules.weights_stay`) each rank looks the tokens up
    in its own shard of the table instead (`_embed_on_mesh`)."""
    cdt = dtype_of(cfg.compute_dtype)
    if weights_stay(tokens, params["tok"]):
        return _embed_on_mesh(params["tok"], tokens, cdt)
    return F.embedding(tokens, constrain(params["tok"], P())).to(cdt)


def _embed_on_mesh(table: DTensor, tokens: DTensor,
                   cdt: torch.dtype) -> DTensor:
    """The lookup on each rank's shard of the table (`local_map`): on a
    mesh dim that shards the vocabulary each rank fills the rows of the
    tokens it holds and zeros elsewhere, a partial sum with one term;
    on one that shards d_model the tokens are gathered there and each
    rank fills its columns.  The rows go to `ACT_TOKENS` after, so
    what moves is the tokens' rows, not the table."""
    mesh = table.device_mesh
    t_pl = tuple(table.placements)
    tok_pl = tuple(Replicate() if tp == Shard(1) else p
                   for tp, p in zip(t_pl, tokens.placements))
    out_pl = tuple(Partial() if tp == Shard(0) else
                   Shard(2) if tp == Shard(1) else p
                   for tp, p in zip(t_pl, tok_pl))
    v0, v1 = local_range(mesh, t_pl, 0, table.shape[0])

    def core(tl, tabl):
        rows = tl.long() - v0
        held = (rows >= 0) & (rows < v1 - v0)
        out = F.embedding(rows.clamp(0, v1 - v0 - 1), tabl).to(cdt)
        return torch.where(held[..., None], out, torch.zeros_like(out))

    out = local_map(core, out_placements=(out_pl,),
                    in_placements=(tok_pl, t_pl), device_mesh=mesh)(
        tokens.redistribute(mesh, tok_pl), table)
    return constrain(out, ACT_TOKENS)


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
            vocab_shards: bool = False) -> torch.Tensor:
    """Logits (..., V) in float32, for a stable softmax-xent: `x @
    unembed` in x's type.

    Over a mesh the product leaves the logits where the table's shards
    put them.  A vocabulary the "model" axis divides
    (`embedding_specs`) shards the table's columns there, so the logits
    come out sharded over "model" by vocabulary and no collective
    carries them.  The odd vocabularies (Mamba-2's 50,280, HuBERT's
    504) shard the table's d_model instead, and the product is a
    partial sum over "model" of the whole logits.  With `vocab_shards`
    (the training loss) such a table is gathered whole and each rank
    computes its own vocabulary block (`_vocab_block_logits`), so the
    loss meets vocabulary shards either way (`vocab_parallel_nll`).
    Serving (the last position's logits) takes the partial sum."""
    w = params["unembed"]
    if vocab_shards and isinstance(w, DTensor):
        blocks = _vocab_block_logits(x, w)
        if blocks is not None:
            return blocks
    return weight_product(x, w, x.dtype).float()


def _vocab_block_logits(x: DTensor, w: DTensor) -> DTensor | None:
    """`x @ w` (w: the stored (D, V) table) in float32, sharded over
    the vocabulary on the mesh dims where `w` shards d_model and `x` is
    replicated, or None where there is no such dim.  The table is
    gathered whole (its bytes, not the logits'), and each rank
    multiplies its rows of `x` by its `local_range` of the columns:
    `torch.chunk`'s blocks, uneven where the dims do not divide V.  Each
    rank's gradient of `x` covers its block's columns, and its
    gradient of the whole table its rows and columns: both ``Partial``
    there, so DTensor sums them, and the table's comes back to its
    shards by a reduce-scatter."""
    mesh = x.device_mesh
    rows = Shard(w.dim() - 2)
    x_pl = tuple(x.placements)
    dims = [i for i, (p, q) in enumerate(zip(w.placements, x_pl))
            if p == rows and q == Replicate()]
    if not dims:
        return None
    out_pl = tuple(Shard(x.dim() - 1) if i in dims else p
                   for i, p in enumerate(x_pl))
    v0, v1 = local_range(mesh, out_pl, x.dim() - 1, w.shape[-1])
    x_grad = tuple(Partial() if i in dims else p for i, p in enumerate(x_pl))
    w_grad = tuple(Partial() if i in dims or p != Replicate() else p
                   for i, p in enumerate(x_pl))
    whole = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
    xl = x.to_local(grad_placements=x_grad)
    wl = whole.to_local(grad_placements=w_grad)[..., v0:v1]
    out = (xl @ wl.to(x.dtype)).float()
    shape = (*x.shape[:-1], w.shape[-1])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


class _BlockNLL(torch.autograd.Function):
    """The NLL of each row on this rank's vocabulary block: `logits`
    (..., Vl) float32 from column `v0`, `targets` (...) global ids;
    `reduce(t, op)` all-reduces over the mesh dims that split the
    vocabulary.  The forward makes three all-reduces of (...) float32:
    the rows' maximum, their sum of exp(logit - max), and the target's
    logit, which only the rank whose block holds it contributes.  The
    backward is softmax - onehot on the block, times the incoming
    gradient, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, v0, reduce):
        n = logits.shape[-1]
        m = reduce(logits.amax(-1), "max")
        e = torch.exp(logits - m[..., None])
        total = reduce(e.sum(-1), "sum")
        idx = targets - v0
        held = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        picked = torch.gather(logits, -1, idx[..., None])[..., 0]
        picked = reduce(torch.where(held, picked, 0.0), "sum")
        ctx.save_for_backward(e, total, idx, held)
        return torch.log(total) + m - picked

    @staticmethod
    def backward(ctx, g):
        e, total, idx, held = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, idx[..., None], -held[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[targets]: (B, S) from `logits` (B, S, V)
    float32 and integer `targets` (B, S).

    A plain tensor, or a DTensor no mesh dim splits by vocabulary,
    takes `F.log_softmax` and `gather`.  Logits sharded over the
    vocabulary (`unembed`'s, over "model"), with their rows over
    ("pod", "data") and the targets over the same rows, stay sharded:
    each rank works on its block under `local_map` (`_BlockNLL`, its
    columns from `rules.local_range`), three all-reduces of float32
    (rows, S) in the forward and none in the backward.  The NLL keeps
    the logits' rows and is replicated over the vocabulary dims."""
    if isinstance(logits, DTensor):
        last = Shard(logits.dim() - 1)
        vocab = [i for i, p in enumerate(logits.placements) if p == last]
    if not isinstance(logits, DTensor) or not vocab:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None])[..., 0]
    mesh = logits.device_mesh
    l_pl = tuple(logits.placements)
    row_pl = tuple(Replicate() if p == last else p for p in l_pl)
    v0 = local_range(mesh, l_pl, logits.dim() - 1, logits.shape[-1])[0]

    def reduce(t, op):
        for i in vocab:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) \
            else t

    def core(ll, tl):
        return _BlockNLL.apply(ll, tl, v0, reduce)

    return local_map(core, out_placements=(row_pl,),
                     in_placements=(l_pl, row_pl), device_mesh=mesh)(
        logits, targets.redistribute(mesh, row_pl))
