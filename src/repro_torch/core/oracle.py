"""Iterative Timeloop-style oracle (the paper's "Timeloop" stand-in).

An *independent* implementation of the accelerator performance model as
an iterative per-level program in plain Python/numpy — the style of
model the paper converts into its closed-form differentiable
counterpart.  `benchmarks/fig4_correlation.py` correlates
`core/model.py` against this oracle exactly as the paper's Fig. 4
correlates DOSA against Timeloop.

Like the closed-form model, the oracle is architecture-generic: it
walks the memory-level chains, EPA and bandwidth models of a
`CompiledSpec` (default: Gemmini), so every `ArchSpec` target gets an
independent cross-check for free.

Deliberate fidelity details:

* integer arithmetic over a validated integer mapping;
* walks the loop nest explicitly (per level, per loop position) to
  compute reuse, instead of the closed-form masked products;
* quantizes backing-store traffic to `dram_block_words` blocks with a
  ceiling — the behaviour the paper names as the source of its
  small-layer Fig. 4 outliers ("Timeloop uses a ceiling function to
  compute energy based on the number of blocks accessed in DRAM");
* rejects invalid mappings (capacity overflow under fixed hardware or
  fixed-silicon levels, non-divisor factors, PE overflow) by returning
  `inf`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .archspec import resolve_spec
from .mapping import ORDER_TABLE, SPATIAL, TEMPORAL, Mapping
# Legacy constant (Gemmini chains), the model's object; the generic path
# reads `cspec.tensor_levels`.
from .model import TENSOR_LEVELS  # noqa: F401
from .problem import (C, K, N, NDIMS, P, Q, R, S, REL, I_T, O_T, W_T, Layer)

@dataclasses.dataclass
class OracleResult:
    latency: float
    energy: float
    edp: float
    accesses: np.ndarray        # (n_levels,)
    caps: np.ndarray            # (n_levels, 3)
    valid: bool
    reason: str = ""


def _tile_extent(m: Mapping, level: int, dim: int) -> int:
    """Extent of dimension `dim` in the tile resident at `level`:
    temporal loops at-or-below the level, spatial loops anywhere."""
    ext = 1
    for j in range(0, level + 1):
        ext *= int(round(m.f[TEMPORAL, j, dim]))
    for j in range(m.f.shape[1]):
        ext *= int(round(m.f[SPATIAL, j, dim]))
    return ext


def _caps(m: Mapping, layer: Layer) -> np.ndarray:
    n_levels = m.f.shape[1]
    caps = np.zeros((n_levels, 3))
    for i in range(n_levels):
        w = 1
        for d in (R, S, C, K):
            w *= _tile_extent(m, i, d)
        pin = layer.wstride * (_tile_extent(m, i, P) - 1) \
            + _tile_extent(m, i, R)
        qin = layer.hstride * (_tile_extent(m, i, Q) - 1) \
            + _tile_extent(m, i, S)
        inp = _tile_extent(m, i, C) * _tile_extent(m, i, N) * pin * qin
        o = 1
        for d in (P, Q, K, N):
            o *= _tile_extent(m, i, d)
        caps[i] = (w, inp, o)
    return caps


def _fill_multiplier(m: Mapping, level: int, tensor: int) -> int:
    """Walk the temporal nest above `level` innermost->outermost; a loop
    contributes iff it's relevant to `tensor`, or some relevant loop with
    factor > 1 lies strictly inner to it."""
    mult = 1
    seen_relevant = False
    for j in range(level + 1, m.f.shape[1]):
        order = ORDER_TABLE[int(m.order[j])]
        for dim in order:                     # innermost -> outermost
            f = int(round(m.f[TEMPORAL, j, dim]))
            relevant = bool(REL[tensor, dim])
            if relevant:
                mult *= f
                if f > 1:
                    seen_relevant = True
            elif seen_relevant:
                mult *= f
    return mult


def _spatial_discount(m: Mapping, level: int, tensor: int) -> int:
    disc = 1
    for dim in range(NDIMS):
        if not REL[tensor, dim]:
            disc *= int(round(m.f[SPATIAL, level, dim]))
    return disc


def evaluate(m: Mapping, layer: Layer, hw=None,
             quantize_dram: bool = True, spec=None) -> OracleResult:
    """Evaluate one layer's mapping.  `hw=None` => mapping-first mode
    (minimal hardware inferred from this mapping alone).  `hw` may be a
    legacy `GemminiHW` or a spec-generic `HWConfig`; `spec` selects the
    target architecture (default Gemmini)."""
    cspec = resolve_spec(spec)
    n_levels, backing = cspec.n_levels, cspec.backing
    dims = np.asarray(layer.dims)
    # ----- validity
    prod = m.f.prod(axis=(0, 1))
    if not np.allclose(prod, dims, rtol=1e-9, atol=1e-6):
        return _invalid("factor products != dims", n_levels)
    if np.any(m.f < 1.0 - 1e-9):
        return _invalid("factor < 1", n_levels)
    fr = np.round(m.f)
    if not np.allclose(m.f, fr, atol=1e-6):
        return _invalid("non-integer factors", n_levels)

    # Level-0 registers hold exactly one element per PE: temporal
    # factors are only realizable for the dataflow's level-0 dims
    # (weight-irrelevant P/Q/N on Gemmini WS).
    for d in range(NDIMS):
        if d in cspec.spec.level0_temporal_dims:
            continue
        if int(round(m.f[TEMPORAL, 0, d])) != 1:
            return _invalid("unrealizable temporal factor at registers",
                            n_levels)

    caps = _caps(m, layer)
    site_factors = [int(round(m.f[SPATIAL, lvl, d]))
                    for (lvl, d) in cspec.spatial_sites]
    pe_dim = max(site_factors, default=1)

    fixed = dict(cspec.fixed_capacity)
    if hw is None:
        if pe_dim > cspec.spec.max_pe_dim:
            return _invalid("PE array exceeds the spec cap", n_levels)
        side = cspec.spec.fixed_pe_dim or pe_dim
        c_pe = side * side
        cap_words = np.full(n_levels, np.inf)
        for i in cspec.searched_levels:        # B-masked (Eq. 5)
            cap_words[i] = sum(caps[i, t] for t in range(3)
                               if cspec.b_matrix[i, t])
        for i, words in fixed.items():
            cap_words[i] = words
    else:
        c_pe, cap_words = cspec.hw_words(hw)
        if pe_dim > hw.pe_dim:
            return _invalid("PE array overflow", n_levels)
    # Constrained capacities (fixed silicon always; searched levels when
    # hardware is given) must hold the mapping's tiles.
    check = (list(fixed) if hw is None
             else list(cspec.searched_levels) + list(fixed))
    for i in check:
        req = sum(caps[i, t] for t in range(3) if cspec.b_matrix[i, t])
        if req > cap_words[i] + 1e-6:
            return _invalid(f"{cspec.level_names[i]} overflow", n_levels)

    macs = int(np.prod(dims, dtype=np.float64))

    reads = np.zeros(n_levels)
    writes = np.zeros(n_levels)
    dram_parts: list[float] = []   # per-tensor backing traffic components
    fills = {}
    for t, levels in cspec.tensor_levels.items():
        for i in levels:
            fills[(t, i)] = caps[i, t] * _fill_multiplier(m, i, t)

    for t in (W_T, I_T):
        levels = cspec.tensor_levels[t]
        reads[levels[0]] += macs / _spatial_discount(m, levels[0], t)
        for pos in range(1, len(levels)):
            i, prev = levels[pos], levels[pos - 1]
            amount = fills[(t, prev)] / _spatial_discount(m, i, t)
            reads[i] += amount
            if i == backing:
                dram_parts.append(amount)
        for i in levels:
            if i != backing:
                writes[i] += fills[(t, i)]

    acc_lvl, top = cspec.tensor_levels[O_T]
    upd = macs / _spatial_discount(m, acc_lvl, O_T)
    nres = fills[(O_T, acc_lvl)]
    osize = caps[top, O_T]
    refetch = max(nres - osize, 0.0)
    writes[acc_lvl] += upd + refetch
    reads[acc_lvl] += (upd - nres) + nres
    writes[top] += nres
    reads[top] += refetch
    dram_parts += [nres, refetch]

    accesses = reads + writes
    if quantize_dram:
        # Timeloop quantizes each tensor's backing-store transfers to
        # blocks with a ceiling — the paper's Fig. 4 small-layer
        # outlier mechanism.
        block = cspec.spec.dram_block_words
        accesses = accesses.copy()
        accesses[backing] = sum(
            math.ceil(p / block) * block for p in dram_parts if p > 0)

    bw = cspec.bandwidth(float(c_pe))
    mem_lat = [accesses[i] / bw[i] for i in range(n_levels)]
    utilized = 1
    for s in site_factors:
        utilized *= s
    compute_lat = macs / utilized
    latency = max(compute_lat, max(mem_lat))

    epa = cspec.epa(float(c_pe), cap_words)
    energy = macs * cspec.spec.epa_mac + sum(accesses[i] * epa[i]
                                             for i in range(n_levels))
    return OracleResult(latency=float(latency), energy=float(energy),
                        edp=float(latency * energy), accesses=accesses,
                        caps=caps, valid=True)


def _invalid(reason: str, n_levels: int = 4) -> OracleResult:
    return OracleResult(latency=float("inf"), energy=float("inf"),
                        edp=float("inf"),
                        accesses=np.full(n_levels, np.inf),
                        caps=np.zeros((n_levels, 3)), valid=False,
                        reason=reason)


def evaluate_workload(mappings: list[Mapping], layers, hw=None,
                      quantize_dram: bool = True, spec=None):
    """Network EDP (Eq. 14): sum energies/latencies across layers (scaled
    by repeats), multiply the sums."""
    e_tot, l_tot = 0.0, 0.0
    results = []
    for mp, layer in zip(mappings, layers):
        r = evaluate(mp, layer, hw=hw, quantize_dram=quantize_dram,
                     spec=spec)
        results.append(r)
        if not r.valid:
            return float("inf"), results
        e_tot += r.energy * layer.repeat
        l_tot += r.latency * layer.repeat
    return e_tot * l_tot, results
