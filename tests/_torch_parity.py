"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
carry reference objects into the port as plain data, and build the same
numpy-seeded inputs for both packages."""
import dataclasses

import numpy as np

from repro.core import archspec as ref_archspec
from repro_torch import convert
from repro_torch.core import archspec as port_archspec
from repro_torch.core import problem as port_problem

REF_SPECS = {"gemmini": ref_archspec.GEMMINI_SPEC,
             "tpu_v5e": ref_archspec.TPU_V5E_SPEC,
             "edge3": ref_archspec.EDGE_SPEC}
PORT_SPECS = {"gemmini": port_archspec.GEMMINI_SPEC,
              "tpu_v5e": port_archspec.TPU_V5E_SPEC,
              "edge3": port_archspec.EDGE_SPEC}
SPEC_NAMES = tuple(REF_SPECS)


def port_spec(name):
    """The port's spec, rebuilt from the reference's dataclass fields."""
    return convert.arch_spec_from_dict(dataclasses.asdict(REF_SPECS[name]))


def port_workload(wl):
    """A port `Workload` with the reference workload's layers."""
    return port_problem.Workload(
        layers=tuple(port_problem.Layer(dims=tuple(lay.dims),
                                        wstride=lay.wstride,
                                        hstride=lay.hstride,
                                        repeat=lay.repeat, name=lay.name)
                     for lay in wl.layers),
        name=wl.name)


def random_population(ref_cspec, dims, n, seed, continuous=False):
    """(f (n, L, 2, nl, 7) float32, orders (n, L, nl) int64) of valid
    integer mappings drawn with the reference's `random_mapping` from a
    numpy Generator; `continuous=True` perturbs the free factors by
    exp(N(0, 0.3)) so they leave the divisor grid."""
    from repro.core.mapping import random_mapping

    rng = np.random.default_rng(seed)
    fs, os_ = [], []
    for _ in range(n):
        ms = [random_mapping(d, rng, spec=ref_cspec) for d in dims]
        fs.append(np.stack([m.f for m in ms]))
        os_.append(np.stack([m.order for m in ms]))
    f = np.asarray(fs, dtype=np.float64)
    if continuous:
        noise = np.exp(rng.normal(0.0, 0.3, size=f.shape))
        f = np.where(ref_cspec.free_mask[None, None], f * noise, f)
    return f.astype(np.float32), np.asarray(os_, dtype=np.int64)


def mapping_fields(ms):
    """Comparable (f, order) arrays of a list of mappings."""
    return [(np.asarray(m.f, dtype=float), np.asarray(m.order))
            for m in ms]


def assert_mappings_equal(a, b):
    assert len(a) == len(b)
    for (fa, oa), (fb, ob) in zip(mapping_fields(a), mapping_fields(b)):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(oa, ob)


# ---------------------------------------------------------------------------
# End-to-end search parity
# ---------------------------------------------------------------------------

# The end-to-end config: 2 segments of 10 steps, 3 start points through
# population=2, so the fused engine pads a ragged second chunk.
E2E = dict(steps=20, round_every=10, n_start_points=3, seed=0)


def reference_search(wl, mode, name, population, fused=True):
    """The reference's driver of the same kind on the E2E config (the
    sequential driver records its history start by start, the
    population engines segment by segment, so each port driver meets
    its own kind)."""
    from repro.core.search import SearchConfig, dosa_search
    cfg = SearchConfig(ordering_mode=mode, spec=REF_SPECS[name], **E2E)
    return dosa_search(wl, cfg, population=population, fused=fused)


def port_search(wl, mode, name, population, fused=True):
    from repro_torch.core.search import SearchConfig, dosa_search
    cfg = SearchConfig(ordering_mode=mode, spec=PORT_SPECS[name], **E2E)
    return dosa_search(port_workload(wl), cfg, population=population,
                       fused=fused, device="cpu")


def assert_search_equal(got, ref):
    assert got.best_edp == ref.best_edp
    assert got.n_evals == ref.n_evals
    assert got.start_edps == ref.start_edps
    assert got.history == ref.history
    assert_mappings_equal(got.best_mappings, ref.best_mappings)
    assert dataclasses.astuple(got.best_hw) == \
        dataclasses.astuple(ref.best_hw)
