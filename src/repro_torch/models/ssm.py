"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060) on torch:
the port of `repro.models.ssm`.

The chunked SSD algorithm in plain torch, as the reference has it in
plain `jnp` (no Pallas kernel):
  * intra-chunk: masked attention-like products (C B^T (.) L) X,
  * chunk states: (B (.) decay)^T X,
  * inter-chunk: a recurrence over chunk states (the reference's
    `lax.scan`, a Python loop over chunks here),
  * output: C h + D-skip.

The reference's 3- and 4-operand einsums are split into products of
two operands, so no (B, nc, nh, ck, ck, hd) tensor is ever formed: the
largest is the (B, nc, nh, ck, ck) decay mask, 1.07 GB in float32 for
Mamba-2 1.3B at 4 x 4096 tokens.  Sums run in another order than the
reference's, within float32 rounding.

The decode path is the exact recurrence h <- a h + dt B x^T, y = C h.

Over a training mesh the heads are sharded over "model": each model
rank scans its `ssm_heads // model` heads on local tensors
(`local_map`), and the output product is a partial sum over "model".
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..sharding.rules import (ACT_TOKENS, ACT_TOKENS_SEQ, P, constrain,
                              local_range, spec, weight_product)
from .layers import dense_init, dtype_of, rmsnorm, rmsnorm_specs


def ssm_init(gen: torch.Generator, cfg: ArchConfig, lead: tuple = (),
             device=None) -> dict:
    """The block's parameters; `lead` prepends stacking dims (the LM's
    n_periods) to every leaf."""
    pdt = dtype_of(cfg.param_dtype)
    dev = gen.device if device is None else device
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def per_head(values: torch.Tensor) -> torch.Tensor:
        return values.expand(*lead, nh).clone()

    return {
        # in_proj -> [z (di), x (di), B (ds), C (ds), dt (nh)]
        "w_in": dense_init(gen, (*lead, d, 2 * di + 2 * ds + nh), pdt,
                           device=dev),
        "w_out": dense_init(gen, (*lead, di, d), pdt,
                            scale=1.0 / math.sqrt(di * 2 * cfg.n_layers),
                            device=dev),
        "a_log": per_head(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=dev))),
        "dt_bias": per_head(torch.zeros((nh,), dtype=torch.float32,
                                        device=dev)),
        "d_skip": per_head(torch.ones((nh,), dtype=torch.float32,
                                      device=dev)),
        "norm": {"scale": torch.ones((*lead, di), dtype=pdt, device=dev)},
    }


def ssm_specs() -> dict:
    """`ssm_init`'s specs: the inner width and the heads over "model"."""
    return {"w_in": spec("embed", "ssm_inner"),
            "w_out": spec("ssm_inner", "embed"),
            "a_log": spec("ssm_heads"), "dt_bias": spec("ssm_heads"),
            "d_skip": spec("ssm_heads"), "norm": rmsnorm_specs()}


def _columns(cfg: ArchConfig, h0: int, h1: int, device) -> torch.Tensor:
    """`w_in`'s columns that heads [h0, h1) read: their z, x and dt
    columns and all of B and C."""
    di, ds, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    inner = torch.arange(h0 * hd, h1 * hd, device=device)
    return torch.cat([inner, di + inner,
                      torch.arange(2 * di, 2 * di + 2 * ds, device=device),
                      torch.arange(2 * di + 2 * ds + h0,
                                   2 * di + 2 * ds + h1, device=device)])


def _split(zxbcdt: torch.Tensor, cfg: ArchConfig, dt_bias: torch.Tensor,
           di: int):
    """(z, x, B, C, dt) of a projection [z (di) | x (di) | B | C | dt],
    dt through the softplus with its heads' `dt_bias`."""
    ds = cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + ds]
    c = zxbcdt[..., 2 * di + ds:2 * di + 2 * ds]
    dt_raw = zxbcdt[..., 2 * di + 2 * ds:]
    # jax.nn.softplus is logaddexp(x, 0).
    pre = dt_raw.float() + dt_bias
    dt = torch.logaddexp(pre, torch.zeros_like(pre))        # (B, S, nh)
    return z, xs, b, c, dt


def _project(params: dict, cfg: ArchConfig, x: torch.Tensor,
             heads: tuple[int, int] | None = None):
    """(z, x, B, C in the compute type; dt float32) of heads [`heads`)
    (all by default): `w_in`'s columns are [z | x | B | C | dt], so a
    block of heads reads its own z, x and dt columns and all of B and
    C.  `params["dt_bias"]` holds those heads' biases."""
    cdt = dtype_of(cfg.compute_dtype)
    nh = cfg.ssm_heads
    h0, h1 = (0, nh) if heads is None else heads
    w = params["w_in"]
    if (h0, h1) != (0, nh):
        w = w.index_select(-1, _columns(cfg, h0, h1, w.device))
    return _split(x @ w.to(cdt), cfg, params["dt_bias"],
                  (h1 - h0) * cfg.ssm_head_dim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[i, j] = sum_{j < l <= i} a[l] for j <= i,
    -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def _ssd_gated(params: dict, cfg: ArchConfig, x: torch.Tensor,
               heads: tuple[int, int] | None = None) -> torch.Tensor:
    """The chunked scan of heads [`heads`) (all by default) on plain
    tensors, gated: y * silu(z), (B, S, heads * head_dim) in the
    compute type, before the norm.  `params` holds `w_in` whole and
    those heads' `a_log`, `dt_bias` and `d_skip`."""
    cdt = dtype_of(cfg.compute_dtype)
    bsz, s, _ = x.shape
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    h0, h1 = (0, cfg.ssm_heads) if heads is None else heads
    nh = h1 - h0
    ck = min(cfg.ssm_chunk, s)
    nc = s // ck
    if nc * ck != s:
        raise ValueError(f"sequence {s} is not a multiple of the SSD "
                         f"chunk {ck}")

    z, xs, b, c, dt = _project(params, cfg, x, heads)
    xh = xs.reshape(bsz, nc, ck, nh, hd).float()
    bm = b.reshape(bsz, nc, ck, ds).float()
    cm = c.reshape(bsz, nc, ck, ds).float()
    dtm = dt.reshape(bsz, nc, ck, nh)
    a = -torch.exp(params["a_log"])                          # (nh,)
    da = dtm * a                                             # (B,nc,ck,nh)
    da_cs = torch.cumsum(da, dim=2)

    # ---- intra-chunk (quadratic within the chunk only):
    # y[i] = sum_j L[h,i,j] (C_i . B_j) dt_j x_j, dt folded into x.
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))        # (B,nc,nh,ck,ck)
    scores = torch.einsum("bnid,bnjd->bnij", cm, bm)         # (B,nc,ck,ck)
    xdt = (xh * dtm[..., None]).permute(0, 1, 3, 2, 4)       # (B,nc,nh,ck,hd)
    y_intra = torch.matmul(lmat * scores[:, :, None], xdt)   # (B,nc,nh,ck,hd)
    del lmat
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                 # (B,nc,ck,nh,hd)

    # ---- chunk states: S_n = sum_j decay_to_end[j] dt[j] B[j] x[j]^T
    decay_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)       # (B,nc,ck,nh)
    states = torch.einsum("bnjd,bnjhp->bnhdp", bm,
                          xh * (decay_end * dtm)[..., None])  # (B,nc,nh,ds,hd)

    # ---- inter-chunk recurrence: h_n = h_{n-1} * exp(sum da_n) + S_n;
    # the state entering chunk n is h_{n-1}.
    chunk_decay = torch.exp(torch.sum(da, dim=2))            # (B,nc,nh)
    h = torch.zeros((bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,nh,ds,hd)

    decay_in = torch.exp(da_cs)                              # (B,nc,ck,nh)
    y_inter = torch.einsum("bnid,bnhdp->bnihp", cm, h_prev) \
        * decay_in[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, nh, hd)
    y = y + xs.reshape(bsz, s, nh, hd).float() \
        * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, nh * hd).to(cdt)
    return y * F.silu(z)


def check_heads_split(cfg: ArchConfig, ways: int) -> None:
    """Raise unless the SSD's heads split evenly over `ways` ranks."""
    if cfg.ssm_heads % ways:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSD heads do not "
                         f"split over {ways} ranks of the 'model' axis "
                         f"(ssm_heads % model = "
                         f"{cfg.ssm_heads % ways})")


def _ssd_on_mesh(params: dict, cfg: ArchConfig, x: DTensor) -> DTensor:
    """`_ssd_gated` on each rank's shards (`local_map`): its rows of the
    batch and its heads, those of its `a_log` shard (the heads over
    "model").  `w_in` comes whole (its columns [z | x | B | C | dt]
    do not split by head), the per-head leaves as they are stored.
    The gated output is sharded over "model" along d_inner, in line
    with `w_out`'s rows, so the norm (over all of d_inner: DTensor sums
    the mean square over "model") and the output product (a partial
    sum over "model", reduce-scattered to the residual stream's
    sequence shards by the constraint to `ACT_TOKENS_SEQ`)
    are DTensor's.  Each rank's x gradient covers its heads, so it is
    ``Partial`` over "model"; the leaves' gradients are ``Partial``
    over the batch axes.  The stream is gathered whole over "model" at
    entry (`ACT_TOKENS`)."""
    x = constrain(x, ACT_TOKENS)
    mesh = x.device_mesh
    head_names = ("a_log", "dt_bias", "d_skip")     # one spec
    a_pl = tuple(params["a_log"].placements)
    hp = [i for i, p in enumerate(a_pl) if p == Shard(0)]
    check_heads_split(cfg, math.prod(mesh.size(i) for i in hp))
    x_pl = tuple(x.placements)
    batch = [i for i, p in enumerate(x_pl) if p == Shard(0)]
    w_in = constrain(params["w_in"], P())
    heads = local_range(mesh, a_pl, 0, cfg.ssm_heads)
    out_pl = tuple(Shard(2) if i in hp else p for i, p in enumerate(x_pl))
    x_grad = tuple(Partial() if i in hp else p for i, p in enumerate(x_pl))
    w_grad = tuple(Partial() if i in hp or i in batch else Replicate()
                   for i in range(len(x_pl)))
    h_grad = tuple(Partial() if i in batch else p
                   for i, p in enumerate(a_pl))

    def core(xl, wl, *per_head):
        return _ssd_gated({"w_in": wl, **dict(zip(head_names, per_head))},
                          cfg, xl, heads)

    return local_map(
        core, out_placements=(out_pl,),
        in_placements=(x_pl, tuple(w_in.placements)) + (a_pl,) * 3,
        in_grad_placements=(x_grad, w_grad) + (h_grad,) * 3,
        device_mesh=mesh)(x, w_in, *(params[n] for n in head_names))


def ssd_forward(params: dict, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Chunked SSD.  x: (B, S, D) -> (B, S, D).  S must be a multiple of
    the chunk min(cfg.ssm_chunk, S).  Over a training mesh (x a
    DTensor) each rank scans its heads (`_ssd_on_mesh`)."""
    cdt = dtype_of(cfg.compute_dtype)
    gated = _ssd_on_mesh(params, cfg, x) if isinstance(x, DTensor) \
        else _ssd_gated(params, cfg, x)
    y = rmsnorm(params["norm"], gated)
    return constrain(weight_product(y, params["w_out"], cdt), ACT_TOKENS_SEQ)


def _step(cfg: ArchConfig, z, xs, b, c, dt, a_log, d_skip, h):
    """One step of the recurrence for the heads of `h` (B, nh, ds, hd)
    float32: (gated y (B, 1, nh * hd) in the compute type, before the
    norm; new h)."""
    cdt = dtype_of(cfg.compute_dtype)
    bsz, nh = h.shape[0], h.shape[1]
    hd, ds = cfg.ssm_head_dim, cfg.ssm_state
    xh = xs.reshape(bsz, nh, hd).float()
    bv = b.reshape(bsz, ds).float()
    cv = c.reshape(bsz, ds).float()
    dtv = dt.reshape(bsz, nh)
    a = -torch.exp(a_log)
    decay = torch.exp(dtv * a)                               # (B, nh)
    h = h * decay[:, :, None, None] \
        + (dtv[:, :, None, None] * bv[:, None, :, None]) * xh[:, :, None, :]
    y = torch.einsum("bd,bhdp->bhp", cv, h)
    y = y + xh * d_skip[None, :, None]
    y = y.reshape(bsz, 1, nh * hd).to(cdt)
    return y * F.silu(z), h


def ssd_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
               h: torch.Tensor):
    """Single-step recurrence.  x: (B, 1, D); h: (B, nh, ds, hd) float32.
    Returns (y (B, 1, D), new h).  Over a mesh (h a DTensor, its heads
    over "model" as `LM.cache_specs` places them) each rank steps its
    heads and writes their state into `h` in place
    (`_ssd_decode_on_mesh`), and the returned h is `h`."""
    cdt = dtype_of(cfg.compute_dtype)
    if isinstance(h, DTensor):
        gated = _ssd_decode_on_mesh(params, cfg, x, h)
    else:
        z, xs, b, c, dt = _project(params, cfg, x)
        gated, h = _step(cfg, z, xs, b, c, dt, params["a_log"],
                         params["d_skip"], h)
    y = rmsnorm(params["norm"], gated)
    return weight_product(y, params["w_out"], cdt), h


def _ssd_decode_on_mesh(params: dict, cfg: ArchConfig, x: DTensor,
                        h: DTensor) -> DTensor:
    """`ssd_decode`'s step on each rank's heads (`local_map`), as
    `_ssd_on_mesh` scans them: the projection is `weight_product`'s
    (the decode step keeps `w_in` where it is stored), then whole over
    "model" (its columns do not split by head, and a row of them is
    small), and each rank takes its heads' columns, steps their state
    and writes it into its shard of `h`.  Returns the gated output
    sharded over "model" along d_inner, in line with `w_out`'s rows,
    before the norm."""
    cdt = dtype_of(cfg.compute_dtype)
    mesh = h.device_mesh
    head_names = ("a_log", "dt_bias", "d_skip")     # one spec
    a_pl = tuple(params["a_log"].placements)
    hp = [i for i, p in enumerate(a_pl) if p == Shard(0)]
    check_heads_split(cfg, math.prod(mesh.size(i) for i in hp))
    h_pl = tuple(h.placements)
    row_pl = tuple(Replicate() if p == Shard(1) else p for p in h_pl)
    out_pl = tuple(Shard(2) if i in hp else p for i, p in enumerate(row_pl))
    h0, h1 = local_range(mesh, a_pl, 0, cfg.ssm_heads)
    zxbcdt = weight_product(x, params["w_in"], cdt).redistribute(mesh,
                                                                 row_pl)

    def core(zl, hl, a_log, dt_bias, d_skip):
        cols = zl.index_select(-1, _columns(cfg, h0, h1, zl.device))
        gated, new_h = _step(cfg, *_split(cols, cfg, dt_bias,
                                          (h1 - h0) * cfg.ssm_head_dim),
                             a_log, d_skip, hl)
        hl.copy_(new_h)
        return gated

    return local_map(core, out_placements=(out_pl,),
                     in_placements=(row_pl, h_pl) + (a_pl,) * 3,
                     device_mesh=mesh)(
        zxbcdt, h, *(params[n] for n in head_names))
