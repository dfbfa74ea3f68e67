"""CoSA stand-in: a constrained heuristic mapper for start points.

The paper seeds gradient descent with CoSA [11] mappings (a Gurobi MIP
scheduler).  Offline we replace it with a greedy prime-factor allocator
that honours the same constraints CoSA is configured with in the paper:

* valid divisors only, products equal the problem dims;
* spatial factors bounded by the PE array;
* every buffer's budget partitioned equally between the tensors the
  spec binds to it (Sec. 6.1: scratchpad split inputs/weights);
* accumulator (and any fixed-silicon) capacity respected;
* loop ordering chosen to minimize EDP (3**(n_levels-1) enumeration).

The allocation schedule (spatial sites, then temporal sites innermost
to outermost) comes from the target's `CompiledSpec`, so the same
greedy mapper seeds every `ArchSpec`.  Its role in DOSA is only
"performant start point / constant mapper"; the Fig. 9 protocol
(constant-mapper comparison) uses it identically.
"""
from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from .archspec import resolve_spec
from .mapping import SPATIAL, TEMPORAL, Mapping
from .oracle import _caps, evaluate
from .problem import NDIMS, Layer, divisors


def _largest_divisor_leq(n: int, cap: int) -> int:
    best = 1
    for d in divisors(n):
        if d <= cap:
            best = d
    return best


def cosa_map(layer: Layer, hw, optimize_order: bool = False,
             spec=None) -> Mapping:
    """Greedy utilization-maximizing valid mapping for `layer` on `hw`
    (a `GemminiHW` or spec-generic `HWConfig`).

    `optimize_order=False` (default) emits the conventional
    weight-stationary loop order at every level — CoSA proper does not
    optimize DOSA's ordering objective, and the paper's Fig. 6
    "Baseline" runs without ordering search.  Set True for an
    ordering-tuned constant mapper."""
    cspec = resolve_spec(spec)
    n_levels = cspec.n_levels
    dims = np.asarray(layer.dims, dtype=np.int64)
    f = np.ones((2, n_levels, NDIMS), dtype=float)
    remaining = dims.copy()

    # Spatial: fill the array as far as divisors allow (Eq. 1 semantics).
    for (lvl, d) in cspec.spatial_sites:
        s = _largest_divisor_leq(int(remaining[d]), hw.pe_dim)
        f[SPATIAL, lvl, d] = s
        remaining[d] //= s

    # Budgets: each level's capacity split equally between the tensors
    # bound there (None = unconstrained level, never checked).
    _, cap_words = cspec.hw_words(hw)
    budgets = []
    for i in range(n_levels - 1):
        if np.isfinite(cap_words[i]):
            n_t = int(cspec.b_matrix[i].sum())
            budgets.append((i, cap_words[i] / n_t))
    del cap_words

    def fits(fc: np.ndarray) -> bool:
        m = Mapping(f=fc, order=np.zeros(n_levels, dtype=np.int64))
        caps = _caps(m, layer)
        for (i, budget) in budgets:
            for t in range(3):
                if cspec.b_matrix[i, t] and caps[i, t] > budget:
                    return False
        return True

    # Greedy temporal allocation, innermost->outermost.  Each site grows
    # its factor to the largest divisor that keeps every buffer within
    # its budget.
    for (lvl, d) in cspec.cosa_sites:
        best = 1
        for cand in divisors(int(remaining[d])):
            trial = f.copy()
            trial[TEMPORAL, lvl, d] *= cand
            if fits(trial):
                best = cand
            else:
                break
        f[TEMPORAL, lvl, d] *= best
        remaining[d] //= best

    for d in range(NDIMS):
        f[TEMPORAL, cspec.backing, d] = remaining[d]

    if not optimize_order:
        return Mapping(f=f, order=np.zeros(n_levels, dtype=np.int64))

    # Ordering: exhaustive 3**(n_levels-1)-way, oracle-EDP per layer.
    best_order, best_edp = None, float("inf")
    for combo in cspec.combos:
        m = Mapping(f=f.copy(), order=np.array(combo, dtype=np.int64))
        r = evaluate(m, layer, hw=hw, quantize_dram=False, spec=cspec)
        if r.edp < best_edp:
            best_edp, best_order = r.edp, np.array(combo, dtype=np.int64)
    if best_order is None:        # nothing fits: keep WS default
        best_order = np.zeros(n_levels, dtype=np.int64)
    return Mapping(f=f, order=best_order)


def cosa_map_workload(layers, hw, optimize_order: bool = False,
                      spec=None) -> list[Mapping]:
    return [cosa_map(lay, hw, optimize_order=optimize_order, spec=spec)
            for lay in layers]


def cosa_seed_population(dims, n: int, generator=None, *, spec=None,
                         pe_cap=None, device=DEFAULT_DEVICE, uniforms=None):
    """Device CoSA seeding: `cosa_map`'s greedy spatial stage (largest
    valid divisor per spatial site, `_largest_divisor_leq`) with uniform
    random temporal factors, over the spec's padded divisor tables —
    `mapping.seed_population` in its "cosa" mode.  No buffer-budget
    fitting (that stays a host concern).  Returns tensors (f, theta,
    orders) for an n-member population on `device`."""
    from .mapping import seed_population

    return seed_population(dims, n, generator, spec=spec, pe_cap=pe_cap,
                           mode="cosa", device=device, uniforms=uniforms)
