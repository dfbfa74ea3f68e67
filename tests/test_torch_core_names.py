"""The reference's public core names that the port restored, each
against the reference called live on the same numpy inputs (the
Gemmini-fixed model wrappers, the baseline accelerators, the identity
mapping, device rounding, the segment runner, ordering selection), the
LRU cache's `get_or_build`, and `workloads.lm_extract`.

Tolerances: model values rtol 1e-5 (float32 results of the same
equations summed in another order, as in tests/test_torch_model.py);
rounded factors, ordering choices, constants, cache counters and
extracted layers exactly; the segment runner (five Adam steps on a
quadratic) rtol 1e-5 (largest error measured 1.6e-6, a few float32
ulps of the Adam arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_population
from repro.configs import get_config as R_get_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.core import arch as R_arch
from repro.core import archspec as R_archspec
from repro.core import lru as R_lru
from repro.core import mapping as R_mapping
from repro.core import model as R
from repro.core import rounding as R_rounding
from repro.core import search as R_search
from repro.workloads import lm_extract as R_extract
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import arch as T_arch
from repro_torch.core import lru as T_lru
from repro_torch.core import mapping as T_mapping
from repro_torch.core import model as T
from repro_torch.core import rounding as T_rounding
from repro_torch.core import search as T_search
from repro_torch.workloads import lm_extract as T_extract

RTOL = 1e-5
P = 3


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), rtol=rtol)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def population(tiny_workload):
    """(f (P, L, 2, 4, 7) continuous, orders, strides, repeats) on
    Gemmini."""
    rc = R_archspec.compile_spec(R_archspec.GEMMINI_SPEC)
    dims = tiny_workload.dims_array()
    f, orders = random_population(rc, dims, P, seed=5, continuous=True)
    strides = tiny_workload.strides_array().astype(np.float32)
    repeats = np.asarray([1.0, 3.0, 2.0], dtype=np.float32)
    return f, orders, strides, repeats


# ---------------------------------------------------------------------------
# arch.py
# ---------------------------------------------------------------------------

def test_baseline_accels_and_level_models():
    assert list(T_arch.BASELINE_ACCELS) == list(R_arch.BASELINE_ACCELS)
    for name, hw in R_arch.BASELINE_ACCELS.items():
        assert dataclasses.asdict(T_arch.BASELINE_ACCELS[name]) == \
            dataclasses.asdict(hw)
    for c_pe in (64.0, 256.0, 1024.0):
        _close(T_arch.bandwidth_words_per_cycle(c_pe),
               R_arch.bandwidth_words_per_cycle(c_pe))
        _close(T_arch.epa_per_level(c_pe, 4096.0, 65536.0),
               R_arch.epa_per_level(c_pe, 4096.0, 65536.0))


# ---------------------------------------------------------------------------
# model.py: the Gemmini-fixed wrappers
# ---------------------------------------------------------------------------

def test_tensor_levels_and_ordering_combos():
    assert T.TENSOR_LEVELS == R.TENSOR_LEVELS
    np.testing.assert_array_equal(T.ordering_combos(), R.ordering_combos())
    assert T.HWParams._fields == R.HWParams._fields


def test_per_layer_wrappers(population):
    f, orders, strides, _ = population
    fl, ol, sl = f[0], orders[0], strides
    for i in range(fl.shape[0]):
        caps_r = R.capacities(jnp.asarray(fl[i]), jnp.asarray(sl[i]))
        caps_t = T.capacities(_t(fl[i]), _t(sl[i]))
        _close(T.fills(_t(fl[i]), _t(ol[i]), _t(sl[i]), caps_t),
               R.fills(jnp.asarray(fl[i]), jnp.asarray(ol[i]),
                       jnp.asarray(sl[i]), caps_r))
        macs = float(np.prod(fl[i].astype(np.float64)))
        tr_t = T.traffic(_t(fl[i]), _t(ol[i]), _t(sl[i]), caps_t,
                         torch.tensor(macs, dtype=torch.float32))
        tr_r = R.traffic(jnp.asarray(fl[i]), jnp.asarray(ol[i]),
                         jnp.asarray(sl[i]), caps_r, jnp.float32(macs))
        for a, b in zip(tr_t, tr_r):
            _close(a, b)
        _close(T.layer_c_pe(_t(fl[i])), R.layer_c_pe(jnp.asarray(fl[i])))
        lm_t = T.layer_metrics(_t(fl[i]), _t(ol[i]), _t(sl[i]), 256.0,
                               5e4, 3e5)
        lm_r = R.layer_metrics(jnp.asarray(fl[i]), jnp.asarray(ol[i]),
                               jnp.asarray(sl[i]), jnp.float32(256.0),
                               jnp.float32(5e4), jnp.float32(3e5))
        for a, b in zip(lm_t, lm_r):
            _close(a, b)
        e_t, l_t = T.layer_el_all_orderings(_t(fl[i]), _t(sl[i]), 256.0,
                                            5e4, 3e5)
        e_r, l_r = R.layer_el_all_orderings(
            jnp.asarray(fl[i]), jnp.asarray(sl[i]), jnp.float32(256.0),
            jnp.float32(5e4), jnp.float32(3e5))
        _close(e_t, e_r)
        _close(l_t, l_r)


def test_workload_and_population_wrappers(population):
    f, orders, strides, repeats = population
    args_t = (_t(f), _t(orders), _t(strides), _t(repeats))
    args_r = tuple(jnp.asarray(x) for x in (f, orders, strides, repeats))
    # Hardware inferred from the mappings (co-search mode).
    hw_t = T.infer_hw_population(_t(f), _t(strides))
    hw_r = R.infer_hw_population(jnp.asarray(f), jnp.asarray(strides))
    for a, b in zip(hw_t, hw_r):
        _close(a, b)
    hw0_t = T.infer_hw(_t(f[0]), _t(strides))
    hw0_r = R.infer_hw(jnp.asarray(f[0]), jnp.asarray(strides))
    for a, b in zip(hw0_t, hw0_r):
        _close(a, b)
    edp_t, (en_t, lat_t, h_t) = T.population_eval(*args_t)
    edp_r, (en_r, lat_r, h_r) = R.population_eval(*args_r)
    for a, b in zip((edp_t, en_t, lat_t, *h_t), (edp_r, en_r, lat_r, *h_r)):
        _close(a, b)
    _close(T.population_edp(*args_t), R.population_edp(*args_r))
    # One workload, inferred and with frozen hardware.
    one_t = (args_t[0][0], args_t[1][0], args_t[2], args_t[3])
    one_r = (args_r[0][0], args_r[1][0], args_r[2], args_r[3])
    hw = (256.0, 8192.0, 65536.0)
    for hw_t1, hw_r1 in ((None, None),
                         (T.HWParams(*hw),
                          R.HWParams(*(jnp.float32(x) for x in hw)))):
        e_t, (en_t, lat_t, h_t) = T.workload_eval(*one_t, hw=hw_t1)
        e_r, (en_r, lat_r, h_r) = R.workload_eval(*one_r, hw=hw_r1)
        for a, b in zip((e_t, en_t, lat_t, *h_t), (e_r, en_r, lat_r, *h_r)):
            _close(a, b)
        _close(T.workload_edp(*one_t, hw=hw_t1),
               R.workload_edp(*one_r, hw=hw_r1))
        if hw_t1 is not None:
            _close(T.capacity_penalty(one_t[0], one_t[2], hw_t1),
                   R.capacity_penalty(one_r[0], one_r[2], hw_r1))
    # Every layer under every ordering, per member.
    e_t, l_t = T.layer_el_all_orderings_population(_t(f), _t(strides),
                                                   hw_t)
    e_r, l_r = R.layer_el_all_orderings_population(
        jnp.asarray(f), jnp.asarray(strides), hw_r)
    _close(e_t, e_r)
    _close(l_t, l_r)


# ---------------------------------------------------------------------------
# mapping.py, rounding.py, search.py
# ---------------------------------------------------------------------------

def test_identity_mapping(tiny_workload):
    for dims in tiny_workload.dims_array():
        t, r = T_mapping.identity_mapping(dims), \
            R_mapping.identity_mapping(dims)
        np.testing.assert_array_equal(t.f, r.f)
        np.testing.assert_array_equal(t.order, r.order)


@pytest.mark.parametrize("pe_cap", [None, 8])
def test_round_population_device(population, tiny_workload, pe_cap):
    f = population[0]
    dims = tiny_workload.dims_array()
    got = T_rounding.round_population_device(f, dims, pe_cap=pe_cap,
                                             device="cpu")
    want = R_rounding.round_population_device(f, dims, pe_cap=pe_cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # One projection per (spec, dims, cap, device), reused.
    T_rounding.round_population_device(f, dims, pe_cap=pe_cap,
                                       device="cpu")
    assert T_rounding._round_device_fn.cache_info().hits >= 1


def test_make_segment_runner():
    """Five Adam steps on sum((theta - target)^2), the target carried
    through as an extra argument."""
    rng = np.random.default_rng(0)
    theta0 = rng.standard_normal((3, 4, 5)).astype(np.float32)
    target = rng.standard_normal((3, 4, 5)).astype(np.float32)

    def r_loss(th, tg):
        return jnp.sum((th - tg) ** 2)

    r_run = R_search.make_segment_runner(
        jax.vmap(jax.value_and_grad(r_loss)), lr=0.1)
    want = r_run(jnp.asarray(theta0), jnp.asarray(target), n_steps=5)

    def t_pop_grad(th, tg):
        return ((th - tg) ** 2).sum(dim=(1, 2)), 2 * (th - tg)

    t_run = T_search.make_segment_runner(t_pop_grad, lr=0.1)
    got = t_run(_t(theta0), _t(target), n_steps=5)
    _close(got, want)


def test_select_orderings(population):
    f, _, strides, repeats = population
    hw_t = T.infer_hw_population(_t(f), _t(strides))
    hw_r = R.infer_hw_population(jnp.asarray(f), jnp.asarray(strides))
    got = T_search.select_orderings_population(_t(f), _t(strides),
                                               _t(repeats), hw_t)
    want = R_search.select_orderings_population(f, strides, repeats, hw_r)
    np.testing.assert_array_equal(got, want)
    for m in range(P):
        hw1_t = T.HWParams(*(x[m] for x in hw_t))
        hw1_r = R.HWParams(*(x[m] for x in hw_r))
        np.testing.assert_array_equal(
            T_search.select_orderings(_t(f[m]), _t(strides), _t(repeats),
                                      hw1_t),
            R_search.select_orderings(f[m], strides, repeats, hw1_r))


# ---------------------------------------------------------------------------
# lru.py
# ---------------------------------------------------------------------------

def test_lru_get_or_build_counts_like_the_reference():
    keys = [1, 2, 1, 3, 4, 2, 5, 1, 1, 3, 6, 4]
    caches = (R_lru.LRUCache(3), T_lru.LRUCache(3))
    built = ([], [])
    for key in keys:
        for cache, log in zip(caches, built):
            value = cache.get_or_build(
                key, lambda k=key, log=log: log.append(k) or f"v{k}")
            assert value == f"v{key}"
    r, t = caches
    assert built[0] == built[1]
    assert (t.hits, t.misses, t.evictions, t.keys()) == \
        (r.hits, r.misses, r.evictions, r.keys())


# ---------------------------------------------------------------------------
# workloads/lm_extract.py (the shapes of tests/test_workloads.py:36-53)
# ---------------------------------------------------------------------------

ARCHS = ["qwen3_0_6b", "gemma_7b", "phi3_5_moe_42b", "mamba2_1_3b",
         "jamba_v0_1_52b", "llama_3_2_vision_90b", "hubert_xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_extract_equals_the_reference(arch):
    cfg, rcfg = get_config(arch), R_get_config(arch)
    for name, shape in SHAPES.items():
        rshape = R_SHAPES[name]
        try:
            want = R_extract.extract(rcfg, rshape)
        except ValueError as e:
            with pytest.raises(ValueError, match="skipped"):
                T_extract.extract(cfg, shape)
            assert "skipped" in str(e)
            continue
        got = T_extract.extract(cfg, shape)
        assert got.name == want.name
        assert [(lay.dims, lay.wstride, lay.hstride, lay.repeat, lay.name)
                for lay in got.layers] == \
            [(tuple(lay.dims), lay.wstride, lay.hstride, lay.repeat,
              lay.name) for lay in want.layers]
