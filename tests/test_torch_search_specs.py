"""End to end on the other shipped specs — TPU v5e (fixed silicon, a
fixed-capacity VMEM) and the 3-level edge3 accelerator (9 ordering
combos) — and on Gemmini with frozen hardware, through the port's
sequential and fused drivers: equal to the reference's results."""
import dataclasses

import pytest

from _torch_parity import (E2E, assert_search_equal, port_search,
                           port_workload, reference_search)
from repro.core.arch import GEMMINI_DEFAULT as R_HW
from repro.core.search import SearchConfig as RConfig
from repro.core.search import dosa_search as r_search
from repro_torch.core.arch import GemminiHW
from repro_torch.core.search import SearchConfig as TConfig
from repro_torch.core.search import dosa_search as t_search

_REF = {}


def _reference(wl, name, population):
    key = (name, population)
    if key not in _REF:
        _REF[key] = reference_search(wl, "iterative", name, population)
    return _REF[key]


@pytest.mark.parametrize("population", [None, 2],
                         ids=["sequential", "fused"])
@pytest.mark.parametrize("name", ["tpu_v5e", "edge3"])
def test_spec_search_matches_reference(name, population, tiny_workload):
    got = port_search(tiny_workload, "iterative", name, population)
    assert_search_equal(got, _reference(tiny_workload, name, population))


@pytest.mark.parametrize("fix_pe_only,population", [(False, 2), (True, None)],
                         ids=["frozen_hw-fused", "frozen_pe-sequential"])
def test_fixed_hardware_search_matches_reference(fix_pe_only, population,
                                                 tiny_workload):
    """Sec. 6.5's frozen-hardware modes: the capacity penalty against a
    fixed hardware point (fused engine) and frozen PE dims with buffers
    re-derived (sequential driver)."""
    hw_t = GemminiHW(**dataclasses.asdict(R_HW))
    ref = r_search(tiny_workload, RConfig(fixed_hw=R_HW,
                                          fix_pe_only=fix_pe_only, **E2E),
                   population=population)
    got = t_search(port_workload(tiny_workload),
                   TConfig(fixed_hw=hw_t, fix_pe_only=fix_pe_only, **E2E),
                   population=population, device="cpu")
    assert_search_equal(got, ref)


@pytest.mark.parametrize("mode,name", [
    ("iterative", "gemmini"), ("none", "gemmini"), ("softmax", "gemmini"),
    ("iterative", "tpu_v5e"), ("iterative", "edge3")])
def test_host_batched_matches_reference(mode, name, tiny_workload):
    """The host-batched engine (``fused=False``): rounding on the host,
    orderings re-selected per chunk, a ragged second chunk padded and
    masked, against the reference's host-batched engine."""
    got = port_search(tiny_workload, mode, name, 2, fused=False)
    assert_search_equal(
        got, reference_search(tiny_workload, mode, name, 2, fused=False))


def test_host_batched_equals_fused(tiny_workload):
    """Both population engines round to the same candidates, so their
    oracle accounting is identical."""
    host = port_search(tiny_workload, "iterative", "gemmini", 2,
                       fused=False)
    assert_search_equal(host, port_search(tiny_workload, "iterative",
                                          "gemmini", 2))
