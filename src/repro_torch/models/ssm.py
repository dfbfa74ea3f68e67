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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.rules import spec
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


def _project(params: dict, cfg: ArchConfig, x: torch.Tensor):
    """(z, x, B, C in the compute type; dt float32)."""
    cdt = dtype_of(cfg.compute_dtype)
    di, ds = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ params["w_in"].to(cdt)
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + ds]
    c = zxbcdt[..., 2 * di + ds:2 * di + 2 * ds]
    dt_raw = zxbcdt[..., 2 * di + 2 * ds:]
    # jax.nn.softplus is logaddexp(x, 0).
    pre = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))        # (B, S, nh)
    return z, xs, b, c, dt


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[i, j] = sum_{j < l <= i} a[l] for j <= i,
    -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def ssd_forward(params: dict, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Chunked SSD.  x: (B, S, D) -> (B, S, D).  S must be a multiple of
    the chunk min(cfg.ssm_chunk, S)."""
    cdt = dtype_of(cfg.compute_dtype)
    bsz, s, _ = x.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ck = min(cfg.ssm_chunk, s)
    nc = s // ck
    if nc * ck != s:
        raise ValueError(f"sequence {s} is not a multiple of the SSD "
                         f"chunk {ck}")

    z, xs, b, c, dt = _project(params, cfg, x)
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
    y = y.reshape(bsz, s, cfg.d_inner).to(cdt)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["w_out"].to(cdt)


def ssd_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
               h: torch.Tensor):
    """Single-step recurrence.  x: (B, 1, D); h: (B, nh, ds, hd) float32.
    Returns (y (B, 1, D), new h)."""
    cdt = dtype_of(cfg.compute_dtype)
    bsz = x.shape[0]
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xs, b, c, dt = _project(params, cfg, x)
    xh = xs.reshape(bsz, nh, hd).float()
    bv = b.reshape(bsz, ds).float()
    cv = c.reshape(bsz, ds).float()
    dtv = dt.reshape(bsz, nh)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dtv * a)                               # (B, nh)
    h = h * decay[:, :, None, None] \
        + (dtv[:, :, None, None] * bv[:, None, :, None]) * xh[:, :, None, :]
    y = torch.einsum("bd,bhdp->bhp", cv, h)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(cdt)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["w_out"].to(cdt), h
