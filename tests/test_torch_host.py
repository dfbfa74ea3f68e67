"""Host foundations of the PyTorch port against the JAX package, held
to exact equality on all three shipped specs: compiled spec tables,
workload bucketing, random mappings and host seeding, host rounding,
the numpy oracle, CoSA start points and hardware inference."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import (PORT_SPECS, REF_SPECS, SPEC_NAMES,
                           assert_mappings_equal, port_spec, port_workload)
from repro.core import archspec as R_arch
from repro.core import cosa as R_cosa
from repro.core import hw_infer as R_hw
from repro.core import mapping as R_map
from repro.core import oracle as R_oracle
from repro.core import rounding as R_round
from repro.core.search import SearchConfig as R_Config
from repro.core.search import generate_start_points
from repro.workloads import dnn_zoo as R_zoo
from repro_torch.core import archspec as T_arch
from repro_torch.core import cosa as T_cosa
from repro_torch.core import hw_infer as T_hw
from repro_torch.core import mapping as T_map
from repro_torch.core import oracle as T_oracle
from repro_torch.core import rounding as T_round
from repro_torch.core import search as T_search
from repro_torch.workloads import dnn_zoo as T_zoo


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_shipped_spec_carries_over(name):
    assert port_spec(name) == PORT_SPECS[name]


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_compile_spec_tables_equal(name, tiny_workload):
    r = R_arch.compile_spec(REF_SPECS[name])
    t = T_arch.compile_spec(PORT_SPECS[name])
    for attr in ("free_mask", "combos", "b_matrix", "word_bytes"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(r, attr))
    for attr in ("n_levels", "backing", "level_names", "searched_levels",
                 "fixed_capacity", "spatial_sites", "cosa_sites",
                 "tensor_levels", "pe_cap"):
        assert getattr(t, attr) == getattr(r, attr), attr
    assert T_arch.sites_per_dim(t) == R_arch.sites_per_dim(r)
    assert T_arch.engine_group_key(PORT_SPECS[name]) == \
        R_arch.engine_group_key(REF_SPECS[name])
    dims = tiny_workload.dims_array()
    for a, b in zip(t.divisor_tables(dims), r.divisor_tables(dims)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    hw = R_hw.random_hw_spec(np.random.default_rng(3), spec=r)
    hw_t = T_arch.HWConfig(pe_dim=hw.pe_dim, cap_kb=hw.cap_kb)
    c_r, w_r = r.hw_words(hw)
    c_t, w_t = t.hw_words(hw_t)
    assert c_t == c_r
    np.testing.assert_array_equal(w_t, w_r)
    assert t.epa(c_r, w_r) == r.epa(c_r, w_r)
    assert t.bandwidth(c_r) == r.bandwidth(c_r)
    assert t.round_caps([1000.0, 70000.0][:len(t.searched_levels)]) == \
        r.round_caps([1000.0, 70000.0][:len(r.searched_levels)])


@pytest.mark.parametrize("wl_name", ["resnet50", "bert", "unet"])
def test_workloads_and_bucketing_equal(wl_name):
    r = getattr(R_zoo, wl_name)()
    t = getattr(T_zoo, wl_name)()
    assert port_workload(r) == t
    rb, tb = R_arch.bucket_workload(r), T_arch.bucket_workload(t)
    assert port_workload(rb) == tb
    assert [R_arch.bucket_dim(n) for n in range(1, 300)] == \
        [T_arch.bucket_dim(n) for n in range(1, 300)]


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_random_mapping_and_host_seeding_equal(name, tiny_workload):
    r, t = REF_SPECS[name], PORT_SPECS[name]
    rng_r, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        for lay in tiny_workload.layers:
            a = R_map.random_mapping(np.asarray(lay.dims), rng_r, spec=r)
            b = T_map.random_mapping(np.asarray(lay.dims), rng_t, spec=t)
            assert_mappings_equal([a], [b])
    dims = tiny_workload.dims_array()
    rng = np.random.default_rng(11)
    s_max = max(len(s) for s in R_arch.sites_per_dim(
        R_arch.compile_spec(r)))
    u_f = rng.random((5, len(dims), 7, s_max), dtype=np.float32)
    u_o = rng.random((5, len(dims), len(r.levels)), dtype=np.float32)
    for mode in ("random", "cosa"):
        fa, oa = R_map.seed_population_host(dims, u_f, u_o, spec=r,
                                            mode=mode)
        fb, ob = T_map.seed_population_host(dims, u_f, u_o, spec=t,
                                            mode=mode)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(oa, ob)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_host_rounding_equal(name, tiny_workload):
    r, t = REF_SPECS[name], PORT_SPECS[name]
    nl = len(r.levels)
    dims = tiny_workload.dims_array()
    rng = np.random.default_rng(5)
    fs = np.exp(rng.normal(1.0, 1.5, size=(6, len(dims), 2, nl, 7)))
    orders = rng.integers(0, 3, size=(6, len(dims), nl))
    for cap in (None, 8):
        a = R_round.round_population(fs, orders, dims, pe_cap=cap, spec=r)
        b = T_round.round_population(fs, orders, dims, pe_cap=cap, spec=t)
        for ma, mb in zip(a, b):
            assert_mappings_equal(ma, mb)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_oracle_equal(name, tiny_workload):
    r, t = REF_SPECS[name], PORT_SPECS[name]
    rng = np.random.default_rng(9)
    lays_r = list(tiny_workload.layers)
    lays_t = list(port_workload(tiny_workload).layers)
    hw = R_hw.random_hw_spec(np.random.default_rng(1), spec=r)
    hw_t = T_arch.HWConfig(pe_dim=hw.pe_dim, cap_kb=hw.cap_kb)
    for _ in range(6):
        ms = [R_map.random_mapping(np.asarray(lay.dims), rng, spec=r)
              for lay in lays_r]
        ms_t = [T_map.Mapping(f=m.f.copy(), order=m.order.copy())
                for m in ms]
        for quant in (True, False):
            for hw_r, hw_p in ((None, None), (hw, hw_t)):
                ea, ra = R_oracle.evaluate_workload(
                    ms, lays_r, hw=hw_r, quantize_dram=quant, spec=r)
                eb, rb = T_oracle.evaluate_workload(
                    ms_t, lays_t, hw=hw_p, quantize_dram=quant, spec=t)
                assert ea == eb or (np.isinf(ea) and np.isinf(eb))
                for x, y in zip(ra, rb):
                    assert (x.latency, x.energy, x.edp, x.valid,
                            x.reason) == (y.latency, y.energy, y.edp,
                                          y.valid, y.reason)
                    np.testing.assert_array_equal(x.accesses, y.accesses)
                    np.testing.assert_array_equal(x.caps, y.caps)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_cosa_and_hw_inference_equal(name, tiny_workload):
    r, t = REF_SPECS[name], PORT_SPECS[name]
    lays_r = list(tiny_workload.layers)
    lays_t = list(port_workload(tiny_workload).layers)
    rng_r, rng_t = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):
        hw_r = R_hw.random_hw_for(R_arch.compile_spec(r), rng_r)
        hw_t = T_hw.random_hw_for(T_arch.compile_spec(t), rng_t)
        assert dataclasses.astuple(hw_r) == dataclasses.astuple(hw_t)
        for opt in (False, True):
            a = R_cosa.cosa_map_workload(lays_r, hw_r, optimize_order=opt,
                                         spec=r)
            b = T_cosa.cosa_map_workload(lays_t, hw_t, optimize_order=opt,
                                         spec=t)
            assert_mappings_equal(a, b)
        ha = R_hw.minimal_hw_for(R_arch.compile_spec(r), a, lays_r)
        hb = T_hw.minimal_hw_for(T_arch.compile_spec(t), b, lays_t)
        assert dataclasses.astuple(ha) == dataclasses.astuple(hb)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_cosa_start_points_equal(name, tiny_workload):
    cfg_r = R_Config(n_start_points=4, seed=3, spec=REF_SPECS[name])
    cfg_t = T_search.SearchConfig(n_start_points=4, seed=3,
                                  spec=PORT_SPECS[name])
    pop_r, edps_r, n_r = generate_start_points(tiny_workload, cfg_r)
    wl_t = port_workload(tiny_workload)
    rec = T_search._Recorder(wl_t, cfg_t, T_arch.resolve_spec(cfg_t.spec))
    pop_t = T_search._start_points(wl_t, cfg_t, rec)
    assert rec.best.start_edps == edps_r and rec.evals == n_r
    for a, b in zip(pop_r, pop_t):
        assert_mappings_equal(a, b)
    free = R_arch.compile_spec(REF_SPECS[name]).free_mask
    from repro.core.search import theta_from_population
    np.testing.assert_array_equal(
        T_search.theta_from_population(pop_t, free),
        theta_from_population(pop_r, free))
