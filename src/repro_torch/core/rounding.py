"""Rounding continuous GD factors to valid integer mappings (Sec. 5.3.2).

"Before any mapping is evaluated, it is rounded to the nearest valid
mapping ... rounding each tiling factor to the nearest divisor of its
corresponding problem dimension, subject to the constraint that the
rounding process does not cause the product of tiling factors for that
dimension to exceed the total problem size.  This process iterates from
the innermost to the outermost memory level."

We make "nearest divisor subject to the constraint" precise by rounding
each factor to the nearest divisor of the *remaining* quotient
(dim / product-of-already-rounded-inner-factors), which guarantees the
inferred backing-store factor (Sec. 5.3.3) is a positive integer.

The site schedule (which (spatial|temporal, level) pairs may hold a
factor of each dim, innermost first) is derived from the target's
`CompiledSpec`; the default is Gemmini.

Two implementations share the projection semantics:

* the host reference (`round_mapping` / `round_all` /
  `round_population`): numpy loops producing `Mapping` objects;
* the device projection (`_round_population_core`): tensor code over
  precomputed padded divisor tables (`archspec.padded_divisor_tables`)
  on the engine's device, the rounding stage of the fused search
  engine.  Instead of recomputing divisors of the *remaining* quotient,
  it masks the full dim's divisor table by remaining-divisibility (an
  identical set, since the remaining quotient always divides the dim)
  and takes the first nearest divisor — the same innermost->outermost
  running-quotient capping, exact integer arithmetic in int64.

Its sibling `_seed_population_core` walks the same site schedule over
the same tables but *draws* each factor from a pre-drawn uniform: the
device seeding stage of the fused engine (`mapping.seed_population`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .archspec import padded_divisor_tables
from .archspec import sites_per_dim as _sites_per_dim
from .archspec import resolve_spec
from .mapping import NORDERS, SPATIAL, TEMPORAL, Mapping
from .problem import NDIMS, divisors


@functools.lru_cache(maxsize=4096)
def _divisors_cached(n: int) -> tuple[int, ...]:
    """Divisor lists recur constantly when rounding whole populations;
    memoize them (problem dims are small and few)."""
    return tuple(divisors(n))


def _nearest_divisor(n: int, x: float, cap: int | None = None) -> int:
    """Divisor of n nearest to x (ties to the smaller), optionally <= cap."""
    best, bestd = 1, abs(1 - x)
    for d in _divisors_cached(n):
        if cap is not None and d > cap:
            continue
        dist = abs(d - x)
        if dist < bestd - 1e-12:
            best, bestd = d, dist
    return best


def round_mapping(f: np.ndarray, order: np.ndarray, dims: np.ndarray,
                  pe_cap: int | None = None, spec=None) -> Mapping:
    """Round continuous factors (2, n_levels, 7) to the nearest valid
    integer mapping; the backing-store temporal factor absorbs the
    remainder.  The per-dim site schedule comes from the compiled spec
    (`archspec.sites_per_dim`, shared with `mapping.random_mapping`);
    `pe_cap=None` bounds spatial factors at the *spec's* PE limit
    (`fixed_pe_dim` or `max_pe_dim`) instead of assuming Gemmini's 128."""
    cspec = resolve_spec(spec)
    if pe_cap is None:
        pe_cap = cspec.pe_cap
    f = np.asarray(f, dtype=float)
    out = np.ones((2, cspec.n_levels, NDIMS), dtype=float)
    per_dim = _sites_per_dim(cspec)
    for d in range(NDIMS):
        remaining = int(dims[d])
        for (k, lvl) in per_dim[d]:
            cap = pe_cap if k == SPATIAL else None
            val = _nearest_divisor(remaining, float(f[k, lvl, d]), cap=cap)
            out[k, lvl, d] = val
            remaining //= val
        out[TEMPORAL, cspec.backing, d] = remaining
    return Mapping(f=out, order=np.asarray(order, dtype=np.int64).copy())


def round_all(fs: np.ndarray, orders: np.ndarray, dims: np.ndarray,
              pe_cap: int | None = None, spec=None) -> list[Mapping]:
    """Round a whole workload: fs (L, 2, n_levels, 7), orders
    (L, n_levels), dims (L, 7)."""
    return [round_mapping(fs[i], orders[i], dims[i], pe_cap=pe_cap,
                          spec=spec)
            for i in range(fs.shape[0])]


def round_population(fs: np.ndarray, orders: np.ndarray, dims: np.ndarray,
                     pe_cap: int | None = None,
                     spec=None) -> list[list[Mapping]]:
    """Round a whole population of workload mappings on the host:
    fs (P, L, 2, n_levels, 7), orders (P, L, n_levels), dims (L, 7).
    Returns one mapping list per population member; the divisor cache is
    shared across members (every member rounds against the same problem
    dims)."""
    return [round_all(fs[p], orders[p], dims, pe_cap=pe_cap, spec=spec)
            for p in range(fs.shape[0])]


# ---------------------------------------------------------------------------
# Device-resident projection (the fused engine's rounding stage)
# ---------------------------------------------------------------------------

class RoundingTables(NamedTuple):
    """Static constants the device projection reads: padded divisor
    tables plus the integer problem dims, as tensors on one device
    (built once per engine, so a chunk never copies them)."""

    divs: torch.Tensor   # (L, 7, D) int64, ascending, zero-padded
    logs: torch.Tensor   # (L, 7, D) float32, log of divs (0 at padding)
    dims: torch.Tensor   # (L, 7) int64


def rounding_tables(dims, device) -> RoundingTables:
    """Divisor tables for a workload's dims on `device`.  Divisors
    depend only on the problem, so every spec's engine for the same
    workload reads the same (cached) numpy tables."""
    divs, logs = padded_divisor_tables(dims)
    dev = torch.device(device)
    return RoundingTables(
        divs=torch.as_tensor(divs.astype(np.int64), device=dev),
        logs=torch.as_tensor(logs.copy(), device=dev),
        dims=torch.as_tensor(np.asarray(dims, dtype=np.int64), device=dev))


@functools.lru_cache(maxsize=64)
def rounding_tables_cached(dims_key: tuple, device) -> RoundingTables:
    """`rounding_tables` of hashable dims, kept per (dims, device): the
    seeding stage reads them without copying anything to the device."""
    return rounding_tables(np.asarray(dims_key, dtype=np.int64), device)


def _round_population_core(cspec, tables: RoundingTables, f, pe_cap):
    """Nearest-divisor projection of a whole population on its device.

    f: (P, L, 2, n_levels, 7) continuous float32 factors; pe_cap: the
    spatial bound (a Python int).  Returns (f_rounded, theta): the
    integer factor tensor and the matching free-site log-factors
    (gathered from the float32 log table, so the GD carry equals
    `theta_from_population` of the rounded mappings bit for bit).

    Mirrors `round_mapping` exactly: per dim, innermost->outermost over
    the spec's site schedule, each site taking the divisor of the
    remaining quotient nearest its continuous factor (ties to the
    smaller divisor: `torch.argmin` returns the first minimum over the
    `inf`-masked distances), spatial sites additionally capped at
    `pe_cap`; the backing-store temporal factor absorbs the remainder.
    Integer arithmetic stays in int64 tensors and nothing reads a value
    back to the host.
    """
    per_dim = _sites_per_dim(cspec)
    P, L = f.shape[0], f.shape[1]
    vals = {}        # (k, lvl, d) -> (P, L) rounded factor
    lgs = {}         # (k, lvl, d) -> (P, L) its float32 log
    backing = []
    for d in range(NDIMS):
        divs = tables.divs[:, d, :]                        # (L, D)
        logs = tables.logs[:, d, :]
        alive = divs > 0
        div_safe = torch.where(alive, divs, torch.ones_like(divs))
        divs_f = divs.to(f.dtype)
        remaining = tables.dims[:, d].expand(P, L)         # (P, L)
        for (k, lvl) in per_dim[d]:
            x = f[:, :, k, lvl, d]                         # (P, L)
            valid = alive & (remaining[..., None] % div_safe == 0)
            if k == SPATIAL:
                valid = valid & (divs <= pe_cap)
            dist = torch.where(valid, (divs_f - x[..., None]).abs(),
                               float("inf"))
            idx = torch.argmin(dist, dim=-1, keepdim=True)  # first nearest
            val = torch.gather(divs.expand_as(valid), -1, idx)[..., 0]
            lgs[(k, lvl, d)] = torch.gather(
                logs.expand_as(valid), -1, idx)[..., 0]
            vals[(k, lvl, d)] = val
            remaining = remaining // val
        backing.append(remaining)
    nl = cspec.n_levels
    one = torch.ones((P, L), dtype=f.dtype, device=f.device)
    zero = torch.zeros((P, L), dtype=f.dtype, device=f.device)
    out_cells, theta_cells = [], []
    for k in range(2):
        for lvl in range(nl):
            for d in range(NDIMS):
                if (k, lvl, d) in vals:
                    out_cells.append(vals[(k, lvl, d)].to(f.dtype))
                    theta_cells.append(lgs[(k, lvl, d)])
                elif k == TEMPORAL and lvl == cspec.backing:
                    out_cells.append(backing[d].to(f.dtype))
                    theta_cells.append(zero)
                else:
                    out_cells.append(one)
                    theta_cells.append(zero)
    shape = (P, L, 2, nl, NDIMS)
    out = torch.stack(out_cells, dim=-1).reshape(shape)
    theta = torch.stack(theta_cells, dim=-1).reshape(shape)
    return out, theta


def round_population_device(fs, dims, pe_cap: int | None = None,
                            spec=None, device=DEFAULT_DEVICE) -> np.ndarray:
    """Device counterpart of `round_population`: project a whole
    population of continuous factors (P, L, 2, n_levels, 7) onto the
    divisor grid on `device` in one pass.  Returns the rounded factor
    tensor as numpy (orders are untouched by rounding — pair the result
    with the caller's orders).  The fused search engines call
    `_round_population_core` directly instead."""
    cspec = resolve_spec(spec)
    if pe_cap is None:
        pe_cap = cspec.pe_cap
    dims_key = tuple(tuple(int(x) for x in row) for row in np.asarray(dims))
    dev = resolve_device(device)
    fn = _round_device_fn(cspec, dims_key, int(pe_cap), dev)
    out, _ = fn(torch.as_tensor(np.asarray(fs), dtype=torch.float32,
                                device=dev))
    return out.cpu().numpy().astype(float)


@functools.lru_cache(maxsize=64)
def _round_device_fn(cspec, dims_key: tuple, pe_cap: int, device):
    """One projection per (spec, dims, cap, device), its divisor tables
    already on the device."""
    tables = rounding_tables_cached(dims_key, device)
    return lambda f: _round_population_core(cspec, tables, f, pe_cap)


def _seed_population_core(cspec, tables: RoundingTables, u_f, u_o,
                          pe_cap, spatial_max: bool):
    """Population seeding on the tables' device — the sibling of
    `_round_population_core`: the same innermost->outermost site walk
    over the padded divisor tables, *drawing* each factor instead of
    projecting one.

    u_f: (P, L, 7, S_max) float32 uniforms, one per (member, layer,
    dim, site); u_o: (P, L, n_levels) float32 uniforms for the
    per-level ordering choice.  Each site takes the
    ``min(trunc(u * n_valid), n_valid - 1)``-th valid divisor of the
    remaining quotient in ascending order (the float32 product and the
    truncation of the reference); spatial sites are capped at `pe_cap`,
    and with `spatial_max=True` take the largest valid divisor instead
    (CoSA's greedy spatial fill).  The selection is the first index
    where the running count of valid divisors reaches pick + 1 (unique,
    so `argmax` needs no tie rule).  The backing store absorbs the
    remainder.  Returns (f, theta, orders): float32 integer factors,
    the free-site log-factors gathered from the float32 log table, and
    int64 ordering choices.  Nothing is read back to the host and no
    tensor is built from host data, so the stage runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    per_dim = _sites_per_dim(cspec)
    P, L = u_f.shape[0], u_f.shape[1]
    vals, lgs, backing = {}, {}, []
    for d in range(NDIMS):
        divs = tables.divs[:, d, :]                        # (L, D)
        logs = tables.logs[:, d, :]
        alive = divs > 0
        div_safe = torch.where(alive, divs, torch.ones_like(divs))
        remaining = tables.dims[:, d].expand(P, L)         # (P, L)
        for si, (k, lvl) in enumerate(per_dim[d]):
            valid = alive & (remaining[..., None] % div_safe == 0)
            if k == SPATIAL:
                valid = valid & (divs <= pe_cap)
            count = valid.sum(dim=-1)                      # (P, L), >= 1
            if k == SPATIAL and spatial_max:
                pick = count - 1                           # largest valid
            else:
                u = u_f[:, :, d, si]
                pick = torch.minimum(
                    (u * count.to(u.dtype)).to(torch.int32).to(count.dtype),
                    count - 1)
            cum = torch.cumsum(valid, dim=-1)
            hit = (cum == pick[..., None] + 1) & valid
            sel = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)
            val = torch.gather(divs.expand_as(valid), -1, sel)[..., 0]
            lgs[(k, lvl, d)] = torch.gather(
                logs.expand_as(valid), -1, sel)[..., 0]
            vals[(k, lvl, d)] = val
            remaining = remaining // val
        backing.append(remaining)
    nl = cspec.n_levels
    dev = u_f.device
    one = torch.ones((P, L), dtype=torch.float32, device=dev)
    zero = torch.zeros((P, L), dtype=torch.float32, device=dev)
    out_cells, theta_cells = [], []
    for k in range(2):
        for lvl in range(nl):
            for d in range(NDIMS):
                if (k, lvl, d) in vals:
                    out_cells.append(vals[(k, lvl, d)].to(torch.float32))
                    theta_cells.append(lgs[(k, lvl, d)])
                elif k == TEMPORAL and lvl == cspec.backing:
                    out_cells.append(backing[d].to(torch.float32))
                    theta_cells.append(zero)
                else:
                    out_cells.append(one)
                    theta_cells.append(zero)
    shape = (P, L, 2, nl, NDIMS)
    out = torch.stack(out_cells, dim=-1).reshape(shape)
    theta = torch.stack(theta_cells, dim=-1).reshape(shape)
    orders = torch.clamp((u_o * NORDERS).to(torch.int32),
                         max=NORDERS - 1).to(torch.int64)
    return out, theta, orders
