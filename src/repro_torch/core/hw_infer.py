"""Mapping-first minimal hardware parameterization (Sec. 4.1, Fig. 3).

Converts a set of layerwise (integer) mappings into the minimal
hardware configuration of a target `ArchSpec` that supports all of
them: per-parameter max across layers, PE array capped at the spec's
limit, SRAM sizes rounded up to the spec's increment (Sec. 6.1).

`minimal_hw` / `random_hw` are the legacy Gemmini entry points
(returning `GemminiHW`); the `*_for` forms work for any compiled spec
and return the generic `HWConfig` (or `GemminiHW` for the Gemmini spec,
so downstream code sees the familiar type).
"""
from __future__ import annotations

import numpy as np

from .arch import GemminiHW
from .archspec import GEMMINI_SPEC, HWConfig, compile_spec, resolve_spec
from .mapping import SPATIAL, Mapping
from .oracle import _caps
from .problem import Layer


def minimal_hw_spec(mappings: list[Mapping], layers: list[Layer],
                    spec=None) -> HWConfig:
    """Minimal hardware point of a spec supporting every mapping."""
    cspec = resolve_spec(spec)
    pe_dim = 1
    req = [0.0] * len(cspec.searched_levels)
    for m, layer in zip(mappings, layers):
        caps = _caps(m, layer)
        for (lvl, d) in cspec.spatial_sites:
            pe_dim = max(pe_dim, int(round(m.f[SPATIAL, lvl, d])))
        for j, i in enumerate(cspec.searched_levels):
            words = sum(float(caps[i, t]) for t in range(3)
                        if cspec.b_matrix[i, t])
            req[j] = max(req[j], words)
    pe_dim = min(pe_dim, cspec.spec.max_pe_dim)
    if cspec.spec.fixed_pe_dim is not None:
        pe_dim = cspec.spec.fixed_pe_dim
    return HWConfig(pe_dim=pe_dim, cap_kb=cspec.round_caps(req))


def minimal_hw_for(cspec, mappings: list[Mapping], layers: list[Layer]):
    """Spec-dispatching form: `GemminiHW` for the Gemmini spec (legacy
    type expected by callers/tests), `HWConfig` otherwise."""
    hw = minimal_hw_spec(mappings, layers, spec=cspec)
    if resolve_spec(cspec).spec is GEMMINI_SPEC:
        return GemminiHW(pe_dim=hw.pe_dim, acc_kb=hw.cap_kb[0],
                         sp_kb=hw.cap_kb[1])
    return hw


def minimal_hw(mappings: list[Mapping], layers: list[Layer]) -> GemminiHW:
    """Legacy Gemmini entry point."""
    return minimal_hw_for(compile_spec(GEMMINI_SPEC), mappings, layers)


def minimal_hw_population_for(cspec, population: list[list[Mapping]],
                              layers: list[Layer]) -> list:
    """Minimal hardware for each member of a population of workload
    mappings on any spec: one hardware point per member, each the
    per-parameter max over that member's layers."""
    return [minimal_hw_for(cspec, mappings, layers)
            for mappings in population]


def minimal_hw_population(population: list[list[Mapping]],
                          layers: list[Layer]) -> list[GemminiHW]:
    """Legacy Gemmini entry point: one GemminiHW per member."""
    return minimal_hw_population_for(compile_spec(GEMMINI_SPEC),
                                     population, layers)


def random_hw_spec(rng: np.random.Generator, spec=None) -> HWConfig:
    """Random valid hardware design (start-point generation, Sec. 5.1).
    Draw order (PE side first, then each searched level inner->outer)
    matches the legacy Gemmini generator, so seeded RNG streams are
    engine- and spec-path-independent."""
    cspec = resolve_spec(spec)
    lo, hi = cspec.spec.rand_pe_log2
    # The drawn side shares the spec's PE bound with rounding and
    # random_mapping (`CompiledSpec.pe_cap`): fixed silicon pins the
    # side outright, a search cap clamps a too-wide random range.  The
    # RNG is consumed either way so seeded streams stay path-identical.
    pe_dim = min(int(2 ** rng.integers(lo, hi)), cspec.pe_cap)
    if cspec.spec.fixed_pe_dim is not None:
        pe_dim = cspec.spec.fixed_pe_dim
    kbs = []
    for i in cspec.searched_levels:
        lvl = cspec.spec.levels[i]
        klo, khi = lvl.rand_log2_kb if lvl.rand_log2_kb is not None \
            else (3, 12)
        kbs.append(float(2 ** rng.integers(klo, khi)))
    return HWConfig(pe_dim=pe_dim, cap_kb=tuple(kbs))


def random_hw_for(cspec, rng: np.random.Generator):
    """Spec-dispatching form of `random_hw` (see `minimal_hw_for`)."""
    hw = random_hw_spec(rng, spec=cspec)
    if resolve_spec(cspec).spec is GEMMINI_SPEC:
        return GemminiHW(pe_dim=hw.pe_dim, acc_kb=hw.cap_kb[0],
                         sp_kb=hw.cap_kb[1])
    return hw


def random_hw(rng: np.random.Generator) -> GemminiHW:
    """Legacy Gemmini entry point: 4..128 PEs, 8..512 KB accumulator,
    32 KB..2 MB scratchpad."""
    return random_hw_for(compile_spec(GEMMINI_SPEC), rng)
