"""DOSA's closed-form differentiable performance model (paper Sec. 4),
on torch tensors.

The PyTorch port of `repro.core.model`: the same equations, written
once over *leading batch dims* instead of per layer under `vmap`.  A
factor tensor is ``f (..., 2, n_levels, 7)``; a whole population of
workload mappings ``(P, L, 2, n_levels, 7)`` (or ``(P, L, n_combos,
2, n_levels, 7)`` when every ordering combo is scored) goes through one
call, and autograd differentiates it with respect to the factors.

* per-level capacity requirements  (Eqs. 2-5),
* traffic: writes / updates / reads with spatial broadcast and
  reduction discounts                (Eqs. 6-11),
* roofline latency                   (Eq. 12),
* event-based energy with capacity-dependent SRAM energy-per-access
  (Eq. 13, Table 2),
* network EDP                        (Eq. 14),
* mapping-first minimal-hardware inference (Eq. 1, Fig. 3).

Every function is parameterized by a `CompiledSpec` (`archspec.py`)
carrying the memory-level chains, tensor bindings, EPA/bandwidth
models and ordering tables of the target.  See the reference module's
docstring for the exact semantics of each term.  The reference's
Gemmini-fixed entry points (`layer_metrics`, `infer_hw`,
`workload_eval`, ..., with hardware as `HWParams`) remain as thin
wrappers over the generic `*_spec` functions specialized to
`GEMMINI_SPEC`.

Two rules keep the model usable inside a fused search chunk, where no
value may travel back to the host: products are written as explicit
multiplications (the backward passes of `torch.prod` and
`torch.cumprod` read a zero count back to the host), and the static
tables the model indexes come from `CompiledSpec.device_tables`, built
once per device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .arch import ACC, NLEVELS, SP
from .archspec import (CompiledSpec, GEMMINI_SPEC, compile_spec,
                       ordering_combos_for)
from .mapping import SPATIAL, TEMPORAL
from .problem import C, K, N, NDIMS, P, Q, R, S, REL, I_T, O_T, W_T

_EPS = 1e-6


def _gemmini() -> CompiledSpec:
    return compile_spec(GEMMINI_SPEC)


# Tensor -> storage levels (from Table 4's B matrix), innermost first.
# Legacy constant; the generic path reads `cspec.tensor_levels`.
TENSOR_LEVELS = {W_T: (0, 2, 3), I_T: (2, 3), O_T: (1, 3)}


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the reference's gradient: `jnp.maximum(x, 0.0)`
    splits the gradient in half at x == 0, which `torch.maximum` does
    and `torch.clamp_min` does not.  Rounded mappings sit on that kink
    (every factor of 1 in the validity penalty), so it matters."""
    return torch.maximum(x, x.new_zeros(()))


def _seq_prod(xs):
    """Left-to-right product of a list of tensors (the reduction order
    of the reference's per-layer `jnp.prod` over a short axis)."""
    out = xs[0]
    for x in xs[1:]:
        out = out * x
    return out


def _prod_all(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Product over the trailing `n_dims` axes, by pairwise halving:
    log2(n) multiplications instead of n, and no `torch.prod` (whose
    backward synchronizes with the host)."""
    x = x.reshape(x.shape[:x.dim() - n_dims] + (-1,))
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = x[..., :n // 2] * x[..., n // 2:2 * (n // 2)]
        x = torch.cat([half, x[..., 2 * (n // 2):]], dim=-1) if n % 2 \
            else half
    return x[..., 0]


class LayerMetrics(NamedTuple):
    latency: torch.Tensor          # cycles
    energy: torch.Tensor           # pJ
    accesses: torch.Tensor         # (..., n_levels) word accesses
    caps: torch.Tensor             # (..., n_levels, 3) capacity words
    macs: torch.Tensor
    compute_latency: torch.Tensor  # cycles
    mem_latency: torch.Tensor      # (..., n_levels) per-level cycles


class SpecHW(NamedTuple):
    """Spec-generic hardware parameters: total PEs plus one capacity per
    memory level (entries of non-searched, unconstrained levels are
    +inf and never read — their EPA slope is zero).  Leaves carry the
    batch dims of whatever they were inferred from."""

    c_pe: torch.Tensor       # (...,) total PEs (pe_dim^2)
    cap_words: torch.Tensor  # (..., n_levels) capacity words per level


# ---------------------------------------------------------------------------
# Capacities
# ---------------------------------------------------------------------------

def _extents(f: torch.Tensor) -> torch.Tensor:
    """ext[..., i, d]: dimension-d extent of the tile resident at level
    i — temporal factors at levels <= i times all spatial factors.
    f: (..., 2, n_levels, 7) -> (..., n_levels, 7)."""
    n_levels = f.shape[-2]
    ft, fsp = f[..., TEMPORAL, :, :], f[..., SPATIAL, :, :]
    sall = _seq_prod([fsp[..., j, :] for j in range(n_levels)])
    tcum, run = [], None
    for j in range(n_levels):
        run = ft[..., j, :] if run is None else run * ft[..., j, :]
        tcum.append(run * sall)
    return torch.stack(tcum, dim=-2)


def capacities(f: torch.Tensor, strides: torch.Tensor) -> torch.Tensor:
    """(..., n_levels, 3) words of tensor t resident at level i
    (Eqs. 2-5).  strides: (..., 2), broadcast against f's batch dims."""
    ext = _extents(f)
    e = [ext[..., d] for d in range(NDIMS)]            # (..., n_levels)
    s0 = strides[..., 0, None]
    s1 = strides[..., 1, None]
    c_w = e[R] * e[S] * e[C] * e[K]
    pin = s0 * (e[P] - 1.0) + e[R]
    qin = s1 * (e[Q] - 1.0) + e[S]
    c_i = e[C] * e[N] * pin * qin
    c_o = e[P] * e[Q] * e[K] * e[N]
    return torch.stack([c_w, c_i, c_o], dim=-1)


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------

def _nest_above(cspec: CompiledSpec, f: torch.Tensor, order: torch.Tensor,
                level: int, tensor: int):
    """Flattened temporal loop nest strictly above `level`, innermost
    first: (factors, rel), each (..., n) with the broadcast batch shape
    of f and order.  Empty nest -> None."""
    n_levels = f.shape[-2]
    if level + 1 >= n_levels:
        return None
    tables = cspec.device_tables(f.device)
    order_tab, rel_tab = tables["order_table"], tables["rel"]
    batch = torch.broadcast_shapes(f.shape[:-3], order.shape[:-1])
    fs, rels = [], []
    for j in range(level + 1, n_levels):
        perm = order_tab[order[..., j]]                       # (..., 7)
        perm = perm.expand(batch + (NDIMS,))
        fj = f[..., TEMPORAL, j, :].expand(batch + (NDIMS,))
        fs.append(torch.gather(fj, -1, perm))
        rels.append(rel_tab[tensor][perm])
    return torch.cat(fs, dim=-1), torch.cat(rels, dim=-1)


def _fill_multiplier(nest_f: torch.Tensor,
                     nest_rel: torch.Tensor) -> torch.Tensor:
    """Masked product over the flattened nest (Eq. 6 reuse rule).  A
    loop's factor multiplies the fills iff the loop is relevant, or some
    relevant loop with factor > 1 lies strictly inner to it."""
    active = nest_rel * (nest_f > 1.0 + _EPS).to(nest_f.dtype)
    seen_excl = torch.cumsum(active, dim=-1) - active         # strictly inner
    include = torch.maximum(nest_rel, (seen_excl > 0.0).to(nest_f.dtype))
    masked = torch.where(include > 0.0, nest_f, 1.0)
    return _seq_prod([masked[..., i] for i in range(masked.shape[-1])])


def spatial_discount(f: torch.Tensor, tensor: int,
                     level: int) -> torch.Tensor:
    """F_S,t(i): product of spatial factors at `level` of dims
    irrelevant to `tensor` (Eqs. 8, 10)."""
    irrel = [d for d in range(NDIMS) if not REL[tensor, d]]
    return _seq_prod([f[..., SPATIAL, level, d] for d in irrel])


def _fills(cspec: CompiledSpec, f, order, caps) -> dict:
    """{(level, tensor): fills} for every bound (level, tensor)."""
    out = {}
    for t, levels in cspec.tensor_levels.items():
        for i in levels:
            nest = _nest_above(cspec, f, order, i, t)
            c = caps[..., i, t]
            out[(i, t)] = c if nest is None else c * _fill_multiplier(*nest)
    return out


def fills_spec(cspec: CompiledSpec, f: torch.Tensor, order: torch.Tensor,
               caps: torch.Tensor) -> torch.Tensor:
    """(..., n_levels, 3) fill (write-from-above) traffic per
    level/tensor (zero where a tensor is not bound)."""
    fl = _fills(cspec, f, order, caps)
    batch = torch.broadcast_shapes(*(v.shape for v in fl.values()))
    zero = caps.new_zeros(batch)
    rows = [torch.stack([fl.get((i, t), zero).expand(batch)
                         for t in range(3)], dim=-1)
            for i in range(cspec.n_levels)]
    return torch.stack(rows, dim=-2)


def fills(f: torch.Tensor, order: torch.Tensor, strides: torch.Tensor,
          caps: torch.Tensor) -> torch.Tensor:
    """Legacy Gemmini entry point (`strides` kept for signature
    compat)."""
    return fills_spec(_gemmini(), f, order, caps)


class Traffic(NamedTuple):
    reads: torch.Tensor      # (..., n_levels) word reads per level
    writes: torch.Tensor     # (..., n_levels) word writes
    accesses: torch.Tensor   # (..., n_levels) reads + writes


def traffic_spec(cspec: CompiledSpec, f: torch.Tensor, order: torch.Tensor,
                 caps: torch.Tensor, macs: torch.Tensor) -> Traffic:
    """Per-level read/write word traffic (Eqs. 6-11 + first-touch).
    Sums are taken in the reference's order, starting from zero."""
    fl = _fills(cspec, f, order, caps)
    n_levels, backing = cspec.n_levels, cspec.backing
    reads = [0.0] * n_levels
    writes = [0.0] * n_levels

    # --- read-only tensors W, I: fills go down the chain as reads above.
    for t in (W_T, I_T):
        levels = cspec.tensor_levels[t]
        inner = levels[0]
        reads[inner] = reads[inner] + macs / spatial_discount(f, t, inner)
        for pos in range(1, len(levels)):
            i, prev = levels[pos], levels[pos - 1]
            reads[i] = reads[i] + fl[(prev, t)] / spatial_discount(f, t, i)
        for i in levels:
            if i != backing:            # data is born in DRAM; no fill there
                writes[i] = writes[i] + fl[(i, t)]

    # --- outputs: accumulate at `acc`, drain/refetch against backing.
    acc, top = cspec.tensor_levels[O_T]
    upd_acc = macs / spatial_discount(f, O_T, acc)   # Eq. 9, innermost
    nres = fl[(acc, O_T)]                            # residencies (words)
    osize = caps[..., top, O_T]                      # distinct output words
    refetch = relu(nres - osize)
    writes[acc] = writes[acc] + (upd_acc + refetch)
    reads[acc] = reads[acc] + ((upd_acc - nres) + nres)
    writes[top] = writes[top] + nres
    reads[top] = reads[top] + refetch

    batch = torch.broadcast_shapes(
        *(x.shape for x in reads + writes if isinstance(x, torch.Tensor)))
    zero = macs.new_zeros(batch)
    reads = torch.stack([zero + x for x in reads], dim=-1)
    writes = torch.stack([zero + x for x in writes], dim=-1)
    return Traffic(reads=reads, writes=writes, accesses=reads + writes)


def traffic(f: torch.Tensor, order: torch.Tensor, strides: torch.Tensor,
            caps: torch.Tensor, macs: torch.Tensor) -> Traffic:
    """Legacy Gemmini entry point (`strides` kept for signature
    compat)."""
    return traffic_spec(_gemmini(), f, order, caps, macs)


# ---------------------------------------------------------------------------
# Latency / energy / EDP
# ---------------------------------------------------------------------------

def utilized_pes(f: torch.Tensor) -> torch.Tensor:
    return _prod_all(f[..., SPATIAL, :, :], 2)


def layer_c_pe_spec(cspec: CompiledSpec, f: torch.Tensor) -> torch.Tensor:
    """Eq. 1: square array sized by the largest free spatial factor."""
    if not cspec.spatial_sites:
        return torch.ones_like(f[..., 0, 0, 0])
    lvl, d = cspec.spatial_sites[0]
    side = f[..., SPATIAL, lvl, d]
    for (lvl, d) in cspec.spatial_sites[1:]:
        side = torch.maximum(side, f[..., SPATIAL, lvl, d])
    return side ** 2


def layer_c_pe(f: torch.Tensor) -> torch.Tensor:
    return layer_c_pe_spec(_gemmini(), f)


def _epa(cspec: CompiledSpec, c_pe, cap_words) -> list:
    """Per-level energy/access; `cap_words` (..., n_levels).  The
    batched twin of `CompiledSpec.epa`."""
    out = []
    for i, lvl in enumerate(cspec.spec.levels):
        e = lvl.epa
        if e.slope == 0.0:
            out.append(e.base)
            continue
        kb = cap_words[..., i] * lvl.word_bytes / 1024.0
        if e.pe_scaled:
            out.append(e.base + e.slope * kb / c_pe ** 0.5)
        else:
            out.append(e.base + e.slope * kb)
    return out


def layer_metrics_spec(cspec: CompiledSpec, f: torch.Tensor,
                       order: torch.Tensor, strides: torch.Tensor,
                       c_pe: torch.Tensor, cap_words) -> LayerMetrics:
    """Latency (Eq. 12) and energy (Eq. 13) of layer mappings given
    hardware parameters.  f (..., 2, n_levels, 7), order (...,
    n_levels), strides (..., 2), c_pe (...), cap_words (...,
    n_levels), all broadcast against each other."""
    caps = capacities(f, strides)
    macs = _prod_all(f, 3)
    tr = traffic_spec(cspec, f, order, caps, macs)
    n_levels = cspec.n_levels

    bw = cspec.bandwidth(c_pe)
    mem_lat = torch.stack([tr.accesses[..., i] / bw[i]
                           for i in range(n_levels)], dim=-1)
    compute_lat = macs / utilized_pes(f)
    latency = torch.maximum(compute_lat, torch.amax(mem_lat, dim=-1))

    epa = _epa(cspec, c_pe, cap_words)
    energy = macs * cspec.spec.epa_mac + sum(tr.accesses[..., i] * epa[i]
                                             for i in range(n_levels))
    return LayerMetrics(latency=latency, energy=energy,
                        accesses=tr.accesses, caps=caps, macs=macs,
                        compute_latency=compute_lat, mem_latency=mem_lat)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _gemmini_cap_words(acc_words, sp_words, like: torch.Tensor,
                       outer: float) -> torch.Tensor:
    """(..., 4) Gemmini capacity words [REG, ACC, SP, DRAM], `outer` at
    REG and DRAM (the reference uses 0 or +inf there; their EPA slope
    is zero, so the value is never read)."""
    acc = _as_tensor(acc_words, like)
    sp = _as_tensor(sp_words, like)
    acc, sp = torch.broadcast_tensors(acc, sp)
    edge = torch.full_like(acc, outer)
    return torch.stack([edge, acc, sp, edge], dim=-1)


def layer_metrics(f: torch.Tensor, order: torch.Tensor,
                  strides: torch.Tensor, c_pe, acc_words,
                  sp_words) -> LayerMetrics:
    """Legacy Gemmini entry point."""
    return layer_metrics_spec(_gemmini(), f, order, strides,
                              _as_tensor(c_pe, f),
                              _gemmini_cap_words(acc_words, sp_words, f,
                                                 0.0))


class HWParams(NamedTuple):
    """Legacy Gemmini hardware parameters (see `SpecHW` for the
    spec-generic form)."""

    c_pe: torch.Tensor       # total PEs (pe_dim^2)
    acc_words: torch.Tensor  # accumulator capacity requirement, words
    sp_words: torch.Tensor   # scratchpad capacity requirement, words


def _spec_hw_from_params(hw: HWParams) -> SpecHW:
    acc = torch.as_tensor(hw.acc_words, dtype=torch.float32)
    return SpecHW(c_pe=_as_tensor(hw.c_pe, acc),
                  cap_words=_gemmini_cap_words(acc, hw.sp_words, acc,
                                               float("inf")))


def _params_from_spec_hw(hw: SpecHW) -> HWParams:
    return HWParams(c_pe=hw.c_pe, acc_words=hw.cap_words[..., ACC],
                    sp_words=hw.cap_words[..., SP])


def infer_hw_spec(cspec: CompiledSpec, fs: torch.Tensor,
                  strides: torch.Tensor) -> SpecHW:
    """Mapping-first minimal hardware (Fig. 3): per-parameter max over
    the layer axis.  fs: (..., L, 2, n_levels, 7), strides: (L, 2).
    Returns SpecHW with (...,) / (..., n_levels) leaves."""
    caps = capacities(fs, strides)                   # (..., L, nl, 3)
    batch = fs.shape[:-4]
    # the PE dims are the spec's Python ints, not tensors
    if cspec.spec.fixed_pe_dim is not None:
        pe = float(cspec.spec.fixed_pe_dim)  # repro-lint: allow[TH101]
        c_pe = fs.new_full(batch, pe ** 2)
    else:
        c_pe = torch.amax(layer_c_pe_spec(cspec, fs), dim=-1)
        pe = float(cspec.spec.max_pe_dim)  # repro-lint: allow[TH101]
        c_pe = torch.minimum(c_pe, c_pe.new_full((), pe ** 2))
    cap_words = []
    fixed = dict(cspec.fixed_capacity)
    for i in range(cspec.n_levels):
        if i in cspec.searched_levels:
            req = sum(caps[..., i, t]
                      for t in range(3) if cspec.b_matrix[i, t])
            cap_words.append(torch.amax(req, dim=-1))       # Eq. 5
        elif i in fixed:
            cap_words.append(fs.new_full(batch, fixed[i]))
        else:
            cap_words.append(fs.new_full(batch, float("inf")))
    return SpecHW(c_pe=c_pe, cap_words=torch.stack(cap_words, dim=-1))


# The population form is the same batched function.
infer_hw_population_spec = infer_hw_spec


def infer_hw(fs: torch.Tensor, strides: torch.Tensor) -> HWParams:
    """Legacy Gemmini entry point; fs (..., L, 2, 4, 7) gives HWParams
    with (...) leaves."""
    return _params_from_spec_hw(infer_hw_spec(_gemmini(), fs, strides))


# Batched like the generic form: (P, L, 2, 4, 7) gives (P,) leaves.
infer_hw_population = infer_hw


def workload_eval_spec(cspec: CompiledSpec, fs: torch.Tensor,
                       orders: torch.Tensor, strides: torch.Tensor,
                       repeats: torch.Tensor, hw: SpecHW | None = None):
    """Evaluate whole networks (Eq. 14).

    fs: (..., L, 2, n_levels, 7); orders: (..., L, n_levels); strides:
    (L, 2); repeats: (L,).  `hw=None` => mapping-first co-search mode
    (hardware inferred per workload, Eq. 1/Fig. 3); a given `hw` with
    scalar leaves is shared.  Returns (edp (...), (energies (..., L),
    latencies (..., L), hw))."""
    if hw is None:
        hw = infer_hw_spec(cspec, fs, strides)
    metrics = layer_metrics_spec(cspec, fs, orders, strides,
                                 hw.c_pe[..., None],
                                 hw.cap_words[..., None, :])
    energies = metrics.energy * repeats
    latencies = metrics.latency * repeats
    edp = energies.sum(dim=-1) * latencies.sum(dim=-1)
    return edp, (energies, latencies, hw)


population_eval_spec = workload_eval_spec


def workload_edp_spec(cspec: CompiledSpec, fs: torch.Tensor,
                      orders: torch.Tensor, strides: torch.Tensor,
                      repeats: torch.Tensor, hw: SpecHW | None = None):
    """The EDP alone of `workload_eval_spec`."""
    return workload_eval_spec(cspec, fs, orders, strides, repeats, hw)[0]


def workload_eval(fs: torch.Tensor, orders: torch.Tensor,
                  strides: torch.Tensor, repeats: torch.Tensor,
                  hw: HWParams | None = None):
    """Legacy Gemmini entry point (hardware in and out as `HWParams`);
    batched over leading dims like `workload_eval_spec`."""
    shw = _spec_hw_from_params(hw) if hw is not None else None
    edp, (en, lat, shw) = workload_eval_spec(_gemmini(), fs, orders,
                                             strides, repeats, hw=shw)
    return edp, (en, lat, _params_from_spec_hw(shw))


def workload_edp(fs, orders, strides, repeats, hw: HWParams | None = None):
    return workload_eval(fs, orders, strides, repeats, hw)[0]


# The population forms are the same batched functions: fs (P, L, 2, 4,
# 7) gives (P,) EDPs, (P, L) energies and latencies, (P,) hw leaves.
population_eval = workload_eval
population_edp = workload_edp


def population_edp_spec(cspec, fs, orders, strides, repeats,
                        hw: SpecHW | None = None) -> torch.Tensor:
    """(P,) network EDPs of a population of candidate mappings."""
    return workload_eval_spec(cspec, fs, orders, strides, repeats, hw)[0]


class PopulationBest(NamedTuple):
    """Per-member running best of a population search (the fused
    engine's best-EDP tracking): the lowest model EDP seen so far plus
    the candidate that achieved it."""

    edp: torch.Tensor      # (P,) best model EDP per member
    f: torch.Tensor        # (P, L, 2, n_levels, 7) best factor tensors
    orders: torch.Tensor   # (P, L, n_levels) best ordering choices


def population_best_init(f: torch.Tensor,
                         orders: torch.Tensor) -> PopulationBest:
    """Empty best-tracking state shaped like one population candidate
    (+inf EDP, so the first update always takes)."""
    return PopulationBest(edp=f.new_full(f.shape[:1], float("inf")),
                          f=torch.zeros_like(f),
                          orders=torch.zeros_like(orders))


def population_best_update(best: PopulationBest, edp: torch.Tensor,
                           f: torch.Tensor,
                           orders: torch.Tensor) -> PopulationBest:
    """Elementwise best-EDP tracking: keep each member's incumbent
    unless the new candidate strictly improves it."""
    take = edp < best.edp                                  # (P,)

    def sel(new, old):
        return torch.where(
            take.reshape(take.shape + (1,) * (new.dim() - 1)), new, old)
    return PopulationBest(edp=torch.where(take, edp, best.edp),
                          f=sel(f, best.f),
                          orders=sel(orders, best.orders))


# ---------------------------------------------------------------------------
# Validity penalty (Eq. 18) and fixed-hardware capacity penalties
# ---------------------------------------------------------------------------

def validity_penalty(fs: torch.Tensor) -> torch.Tensor:
    """sum max(1 - f, 0) over each workload's factors (Sec. 5.3.3):
    fs (..., L, 2, n_levels, 7) -> (...)."""
    return relu(1.0 - fs).sum(dim=(-4, -3, -2, -1))


def capacity_penalty_spec(cspec: CompiledSpec, fs: torch.Tensor,
                          strides: torch.Tensor, hw: SpecHW) -> torch.Tensor:
    """Relative overflow of fixed buffers — used when hardware is frozen
    (Sec. 6.5: buffer-size/mapping-only search).  fs (..., L, 2,
    n_levels, 7) -> (...)."""
    caps = capacities(fs, strides)
    constrained = tuple(cspec.searched_levels) + tuple(
        i for (i, _) in cspec.fixed_capacity)
    pe = layer_c_pe_spec(cspec, fs)                      # (..., L)
    over = relu(pe / hw.c_pe[..., None] - 1.0)
    for i in constrained:
        req = sum(caps[..., i, t] for t in range(3) if cspec.b_matrix[i, t])
        over = over + relu(req / hw.cap_words[..., None, i] - 1.0)
    return over.sum(dim=-1)


def capacity_penalty(fs: torch.Tensor, strides: torch.Tensor,
                     hw: HWParams) -> torch.Tensor:
    """Legacy Gemmini entry point."""
    return capacity_penalty_spec(_gemmini(), fs, strides,
                                 _spec_hw_from_params(hw))


# ---------------------------------------------------------------------------
# Loop-ordering enumeration helpers (Sec. 5.2)
# ---------------------------------------------------------------------------

def ordering_combos():
    """(27, 4) all per-level ordering choices for levels ACC/SP/DRAM
    (the register level's ordering never affects traffic).  The array
    is cached and READ-ONLY — copy before mutating."""
    return ordering_combos_for(NLEVELS)


def layer_el_all_orderings_spec(cspec: CompiledSpec, f, strides, c_pe,
                                cap_words):
    """Energy & latency of layer mappings under all 3**(n_levels-1)
    ordering combos.  f (..., 2, n_levels, 7), strides (..., 2), c_pe
    (...), cap_words (..., n_levels).  Returns (energies, latencies),
    each (..., n_combos)."""
    combos = cspec.device_tables(f.device)["combos"]
    m = layer_metrics_spec(cspec, f[..., None, :, :, :], combos,
                           strides[..., None, :], c_pe[..., None],
                           cap_words[..., None, :])
    return m.energy, m.latency


def layer_el_all_orderings(f, strides, c_pe, acc_words, sp_words):
    """Legacy Gemmini entry point: all 27 combos."""
    return layer_el_all_orderings_spec(
        _gemmini(), f, strides, _as_tensor(c_pe, f),
        _gemmini_cap_words(acc_words, sp_words, f, 0.0))


def layer_el_all_orderings_population_spec(cspec: CompiledSpec,
                                           fs_pop: torch.Tensor,
                                           strides: torch.Tensor,
                                           hws: SpecHW):
    """Energy & latency of every layer of every population member under
    all ordering combos, as one batched computation.  fs_pop:
    (P, L, 2, n_levels, 7); hws: SpecHW with (P,)/(P, n_levels) leaves.
    Returns (energies, latencies), each (P, L, n_combos)."""
    return layer_el_all_orderings_spec(cspec, fs_pop, strides,
                                       hws.c_pe[..., None],
                                       hws.cap_words[..., None, :])


def layer_el_all_orderings_population(fs_pop: torch.Tensor,
                                      strides: torch.Tensor, hws: HWParams):
    """Legacy Gemmini entry point.  hws: HWParams with (P,) leaves.
    Returns (energies, latencies), each (P, L, 27)."""
    return layer_el_all_orderings_population_spec(
        _gemmini(), fs_pop, strides, _spec_hw_from_params(hws))
