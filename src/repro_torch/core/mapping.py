"""Mapping representation and loop orderings.

A mapping for one layer is:

* `f[2, 4, 7]` — spatial (row 0) and temporal (row 1) tiling factors per
  memory level per problem dimension (Sec. 3.1.2).  The Gemmini WS
  dataflow fixes spatial factors to 1 everywhere except `f[S, ACC, C]`
  (input channels across array rows, spatially reduced) and
  `f[S, SP, K]` (output channels across array columns, broadcast inputs)
  — Eq. 1 and Sec. 5.1.

* `order[4]` — per-level loop-ordering choice in {WS, IS, OS}
  (Sec. 5.2).  Only levels >= 1 influence traffic (fills into level i
  depend on loop orders at levels j > i).

Constraint: for every dimension d, prod over (k, i) of f[k, i, d] equals
the problem size (Sec. 3.1.2).  During gradient descent the DRAM temporal
factor is *inferred* (Sec. 5.3.3), so the constraint holds by
construction in continuous space.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .arch import ACC, SP
from .archspec import resolve_spec, sites_per_dim
from .problem import C, K, N, NDIMS, P, Q, R, S

SPATIAL, TEMPORAL = 0, 1

# Positions of the two free spatial factors in the Gemmini WS dataflow.
SPATIAL_SITES = ((ACC, C), (SP, K))

# ---------------------------------------------------------------------------
# Loop orderings (Sec. 5.2): three named per-level dim orders, innermost
# first.  X-stationary places the dims *irrelevant* to tensor X innermost,
# maximizing X's reuse at that level boundary.
# ---------------------------------------------------------------------------
WS_ORD, IS_ORD, OS_ORD = 0, 1, 2
ORDER_NAMES = ("WS", "IS", "OS")
# innermost -> outermost
ORDER_TABLE = np.array(
    [
        [P, Q, N, R, S, C, K],  # WS: P,Q,N (irrelevant to W) innermost
        [K, R, S, P, Q, C, N],  # IS: K (irrelevant to I) innermost
        [R, S, C, P, Q, K, N],  # OS: R,S,C (irrelevant to O) innermost
    ],
    dtype=np.int64,
)
NORDERS = 3


@dataclasses.dataclass
class Mapping:
    """Concrete (integer) mapping for one layer."""

    f: np.ndarray       # (2, 4, 7) float or int factors
    order: np.ndarray   # (4,) int in {0, 1, 2}

    def copy(self) -> "Mapping":
        return Mapping(f=self.f.copy(), order=self.order.copy())

    def spatial(self, level: int, dim: int) -> float:
        return float(self.f[SPATIAL, level, dim])

    def validate(self, dims: np.ndarray, atol: float = 1e-6,
                 spec=None) -> None:
        """Raise if factor products don't match problem dims or the
        target dataflow's fixed spatial sites are violated.  `spec`
        selects the target (`ArchSpec` / `CompiledSpec`; default
        Gemmini), so fleet code can assert start-point validity against
        every member of a spec portfolio."""
        cspec = resolve_spec(spec)
        if self.f.shape != (2, cspec.n_levels, NDIMS):
            raise ValueError(f"factor tensor {self.f.shape} does not fit "
                             f"{cspec.spec.name}'s (2, {cspec.n_levels}, "
                             f"{NDIMS}) hierarchy")
        prod = self.f.prod(axis=(0, 1))
        if not np.allclose(prod, dims, rtol=1e-6, atol=atol):
            raise ValueError(f"factor products {prod} != dims {dims}")
        mask = np.ones((cspec.n_levels, NDIMS), dtype=bool)
        for lvl, d in cspec.spatial_sites:
            mask[lvl, d] = False
        if not np.allclose(self.f[SPATIAL][mask], 1.0):
            raise ValueError(
                f"spatial factor outside {cspec.spec.name} dataflow sites")


def random_mapping(dims: np.ndarray, rng: np.random.Generator,
                   max_pe_dim: int | None = None, spec=None) -> Mapping:
    """Uniform-ish random valid integer mapping: per dim, split the prime
    factorization across the target's factor sites (spatial sites +
    realizable temporal levels), the backing store absorbing the
    remainder.  The site schedule comes from the compiled spec
    (`archspec.sites_per_dim`, shared with rounding), so random mappings
    are valid for any `ArchSpec` — for Gemmini the schedule reproduces
    the legacy hard-coded site list, keeping seeded draws bit-identical.
    `max_pe_dim=None` caps spatial factors at the spec's PE bound
    (`fixed_pe_dim` or `max_pe_dim`)."""
    from .problem import divisors

    cspec = resolve_spec(spec)
    cap = cspec.pe_cap if max_pe_dim is None else max_pe_dim
    f = np.ones((2, cspec.n_levels, NDIMS), dtype=float)
    for d in range(NDIMS):
        remaining = int(dims[d])
        for (k, lvl) in sites_per_dim(cspec)[d]:
            divs = [x for x in divisors(remaining)]
            if k == SPATIAL:
                divs = [x for x in divs if x <= cap]
            pick = int(rng.choice(divs))
            f[k, lvl, d] = pick
            remaining //= pick
        f[TEMPORAL, cspec.backing, d] = remaining
    order = rng.integers(0, NORDERS, size=cspec.n_levels)
    return Mapping(f=f, order=order.astype(np.int64))


# ---------------------------------------------------------------------------
# Population seeding: the host twin (the device kernel is not ported yet)
# ---------------------------------------------------------------------------

def seed_population(*args, **kwargs):
    """On-device population seeding (the reference's
    `mapping.seed_population`) is not ported yet; its host twin
    `seed_population_host` is."""
    raise NotImplementedError(
        "device seeding is not ported yet (ROADMAP queue 1: "
        "Device seeding); use start_points='cosa'")


def seed_population_host(dims, u_f, u_o, *, spec=None, pe_cap=None,
                         mode: str = "random"):
    """Numpy twin of the reference's device seeding kernel: the
    `random_mapping` site walk, driven by pre-drawn uniforms instead of
    a Generator (pick = floor(u * n_valid) over the ascending valid
    divisors — exactly how `rng.choice` consumes a uniform).  Returns
    (f, orders) numpy arrays; the float32 index arithmetic matches the
    reference's."""
    from .problem import divisors

    cspec = resolve_spec(spec)
    cap = cspec.pe_cap if pe_cap is None else int(pe_cap)
    if mode not in ("random", "cosa"):
        raise ValueError(f"unknown seeding mode {mode!r}")
    u_f = np.asarray(u_f, dtype=np.float32)
    u_o = np.asarray(u_o, dtype=np.float32)
    n, L = u_f.shape[0], u_f.shape[1]
    dims = np.asarray(dims)
    f = np.ones((n, L, 2, cspec.n_levels, NDIMS), dtype=np.float32)
    for p in range(n):
        for li in range(L):
            for d in range(NDIMS):
                remaining = int(dims[li, d])
                for si, (k, lvl) in enumerate(sites_per_dim(cspec)[d]):
                    divs = [x for x in divisors(remaining)]
                    if k == SPATIAL:
                        divs = [x for x in divs if x <= cap]
                    if k == SPATIAL and mode == "cosa":
                        pick = divs[-1]
                    else:
                        u = u_f[p, li, d, si]
                        j = min(int(u * np.float32(len(divs))),
                                len(divs) - 1)
                        pick = divs[j]
                    f[p, li, k, lvl, d] = pick
                    remaining //= pick
                f[p, li, TEMPORAL, cspec.backing, d] = remaining
    orders = np.minimum((u_o * np.float32(NORDERS)).astype(np.int32),
                        NORDERS - 1)
    return f, orders


def stack_mappings(mappings: list[Mapping]) -> tuple[np.ndarray, np.ndarray]:
    """(L, 2, 4, 7) factors and (L, 4) orders for a whole workload."""
    f = np.stack([m.f for m in mappings]).astype(float)
    o = np.stack([m.order for m in mappings]).astype(np.int64)
    return f, o


def unstack_mappings(f: np.ndarray, order: np.ndarray) -> list[Mapping]:
    return [Mapping(f=np.asarray(f[i], dtype=float),
                    order=np.asarray(order[i], dtype=np.int64))
            for i in range(f.shape[0])]
