"""The port's calibration subsystem and RTL stand-in against the
reference's, on all three shipped specs, and the co-search descending
through a learned latency model carried from the reference.

Exact: `featurize_spec`, `n_features`, `default_hw_for`, the RTL
stand-in (`rtl_latency`, `_mapping_noise`, `rtl_workload_edp`),
`EpaModel.fit`, `measured_epa_samples`, `calibrate_epa` and
`build_calibration_dataset`: host numpy on both sides.

Within a tolerance (float32 on both sides, reduced in another order):
`traced_features` against the host featurizer, rtol 1e-6; the search
loss with a carried surrogate, rtol 1e-5, and its gradient, rtol 1e-4
(as in tests/test_torch_model.py); `predicted_edp_fn` and the search's
`best_edp` through it, rtol 1e-5.  The searches' sample counts and
best mappings are exact: rounding snaps both onto the same divisor
grid."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PORT_SPECS, REF_SPECS, SPEC_NAMES,
                           assert_mappings_equal, port_workload,
                           random_population)
from repro.core import calibration as RC
from repro.core import rtl_sim as RR
from repro.core import search as RSearch
from repro.core import surrogate as RSur
from repro.core.archspec import EpaModel as R_Epa
from repro.core.archspec import compile_spec as r_compile
from repro.core.mapping import random_mapping
from repro.core.problem import Layer as RLayer
from repro.core.problem import Workload as RWorkload
from repro_torch import convert
from repro_torch.core import calibration as TC
from repro_torch.core import rtl_sim as TR
from repro_torch.core import search as TSearch
from repro_torch.core import surrogate as TSur
from repro_torch.core.arch import GemminiHW
from repro_torch.core.archspec import EpaModel as T_Epa
from repro_torch.core.archspec import HWConfig
from repro_torch.core.archspec import compile_spec as t_compile
from repro_torch.core.mapping import Mapping
from repro_torch.core.model import SpecHW


@pytest.fixture(scope="module")
def small_workload():
    """The reference calibration tests' two-layer workload."""
    return RWorkload(layers=(RLayer.conv(32, 64, 3, 28, name="c"),
                             RLayer.matmul(256, 512, 384, name="m")),
                     name="small")


def _t_hw(hw):
    """A reference hardware point as the port's."""
    if hasattr(hw, "acc_kb"):
        return GemminiHW(pe_dim=hw.pe_dim, acc_kb=hw.acc_kb, sp_kb=hw.sp_kb)
    return HWConfig(pe_dim=hw.pe_dim, cap_kb=tuple(hw.cap_kb))


def _t_map(m):
    return Mapping(f=np.array(m.f), order=np.array(m.order))


def _t_layers(layers):
    return list(port_workload(RWorkload(layers=tuple(layers),
                                        name="x")).layers)


def _draw(name, layers, n, seed, hw=None):
    """n random valid-or-not mappings per layer, drawn by the
    reference: [(layer index, mapping)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i, lay in enumerate(layers):
        for _ in range(n):
            out.append((i, random_mapping(
                np.asarray(lay.dims), rng, spec=REF_SPECS[name],
                max_pe_dim=None if hw is None else hw.pe_dim)))
    return out


# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES)
def test_featurize_spec_exact(name, small_workload):
    spec_r, spec_t = REF_SPECS[name], PORT_SPECS[name]
    assert TC.n_features(spec_t) == RC.n_features(spec_r)
    hw_r = RC.default_hw_for(spec_r)
    hw_t = TC.default_hw_for(spec_t)
    assert dataclasses.astuple(hw_t) == dataclasses.astuple(hw_r)
    layers_r = list(small_workload.layers)
    layers_t = _t_layers(layers_r)
    for i, m in _draw(name, layers_r, 6, seed=3):
        got = TC.featurize_spec(_t_map(m), layers_t[i], hw_t, spec=spec_t)
        want = RC.featurize_spec(m, layers_r[i], hw_r, spec=spec_r)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    m3 = random_mapping(np.asarray(layers_r[0].dims),
                        np.random.default_rng(0), spec=REF_SPECS["edge3"])
    if name == "gemmini":      # the other two are 3-level hierarchies
        with pytest.raises(ValueError, match="hierarchy"):
            TC.featurize_spec(_t_map(m3), layers_t[0], hw_t, spec=spec_t)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_traced_features_match_host_featurizer(name, small_workload):
    """The in-loss feature path, batched over a population, against the
    host featurizer on the same integer mappings (rtol 1e-6)."""
    spec_t = PORT_SPECS[name]
    cspec = t_compile(spec_t)
    rc = r_compile(REF_SPECS[name])
    dims = small_workload.dims_array()
    f, orders = random_population(rc, dims, 3, seed=11)
    hw_t = TC.default_hw_for(spec_t)
    c_pe, cap_words = cspec.hw_words(hw_t)
    shw = SpecHW(c_pe=torch.full((3,), float(c_pe)),
                 cap_words=torch.as_tensor(
                     np.tile(np.asarray(cap_words, dtype=np.float32),
                             (3, 1))))
    theta = np.where(cspec.free_mask[None, None],
                     np.log(np.maximum(f, 1.0)), 0.0).astype(np.float32)
    logdims = torch.log(torch.as_tensor(dims.astype(np.float32)))
    got = TC.traced_features(cspec, torch.from_numpy(theta),
                             torch.from_numpy(orders), logdims, shw).numpy()
    layers_t = _t_layers(small_workload.layers)
    assert got.shape == (3, len(layers_t), TC.n_features(spec_t))
    for p in range(3):
        host = np.stack([
            TC.featurize_spec(Mapping(f=f[p, i].astype(float),
                                      order=orders[p, i]),
                              lay, hw_t, spec=spec_t)
            for i, lay in enumerate(layers_t)])
        np.testing.assert_allclose(got[p], host, rtol=1e-6, atol=1e-6)


def test_check_surrogate(small_workload):
    ds = TC.build_calibration_dataset(_t_layers(small_workload.layers),
                                      spec=PORT_SPECS["gemmini"],
                                      n_per_layer=6)
    model = TSur.train_residual_model(ds.features, ds.analytical, ds.target,
                                      epochs=2, device="cpu")
    TC.check_surrogate(model, PORT_SPECS["gemmini"])
    with pytest.raises(ValueError, match="features"):
        TC.check_surrogate(model, PORT_SPECS["edge3"])
    with pytest.raises(ValueError, match="features"):
        TSearch.SearchConfig(spec=PORT_SPECS["edge3"], surrogate=model)
    twin = dataclasses.replace(PORT_SPECS["gemmini"], name="gemmini2")
    with pytest.raises(ValueError, match="calibrated for"):
        TC.check_surrogate(model, twin)


# ---------------------------------------------------------------------------
# The RTL stand-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES)
def test_rtl_latency_exact(name, small_workload):
    spec_r, spec_t = REF_SPECS[name], PORT_SPECS[name]
    hw_r = RC.default_hw_for(spec_r)
    hw_t = TC.default_hw_for(spec_t)
    layers_r = list(small_workload.layers)
    layers_t = _t_layers(layers_r)
    n_finite = 0
    for i, m in _draw(name, layers_r, 8, seed=5, hw=hw_r):
        mt = _t_map(m)
        assert TR._mapping_noise(mt, layers_t[i]) == \
            RR._mapping_noise(m, layers_r[i])
        got = TR.rtl_latency(mt, layers_t[i], hw_t, spec=spec_t)
        want = RR.rtl_latency(m, layers_r[i], hw_r, spec=spec_r)
        assert got == want or (np.isinf(got) and np.isinf(want))
        n_finite += np.isfinite(want)
    assert n_finite >= 3
    # Whole-network RTL EDP of the reference's CoSA mappings.
    from repro.core.cosa import cosa_map_workload
    maps = cosa_map_workload(layers_r, hw_r, spec=spec_r)
    got = TR.rtl_workload_edp([_t_map(m) for m in maps], layers_t, hw_t,
                              spec=spec_t)
    assert got == RR.rtl_workload_edp(maps, layers_r, hw_r, spec=spec_r)


def test_build_dataset_legacy_exact(small_workload):
    from repro.core.arch import GEMMINI_DEFAULT as R_HW
    got = TR.build_dataset(_t_layers(small_workload.layers),
                           _t_hw(R_HW), n_per_layer=5, seed=2)
    want = RR.build_dataset(list(small_workload.layers), R_HW,
                            n_per_layer=5, seed=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Fitted EPA
# ---------------------------------------------------------------------------

def test_epa_fit_exact():
    rng = np.random.default_rng(0)
    kb = np.logspace(0, 3, 40)
    c_pe = np.tile([64.0, 256.0, 1024.0], 14)[:40]
    cases = [
        (kb, 256.0, 1.5 + 0.02 * kb, False),                 # exact affine
        (kb, c_pe, 2.0 + 0.1 * kb / np.sqrt(c_pe), None),    # pe_scaled
        (kb, c_pe, 2.0 + 0.01 * kb * rng.uniform(0.9, 1.1, 40), None),
        (np.linspace(1, 100, 20), 256.0,
         5.0 - 0.01 * np.linspace(1, 100, 20), False),       # clamp slope
        (kb, 256.0, -1.0 + 0.05 * kb, False),                # clamp base
    ]
    for k, c, pj, scaled in cases:
        assert dataclasses.astuple(T_Epa.fit(k, c, pj, pe_scaled=scaled)) \
            == dataclasses.astuple(R_Epa.fit(k, c, pj, pe_scaled=scaled))
    with pytest.raises(ValueError, match="mismatch"):
        T_Epa.fit(kb, 256.0, kb[:5])


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_measured_samples_and_calibrate_epa_exact(name):
    spec_r, spec_t = REF_SPECS[name], PORT_SPECS[name]
    for i in range(len(spec_r.levels)):
        for a, b in zip(TC.measured_epa_samples(spec_t, i),
                        RC.measured_epa_samples(spec_r, i)):
            np.testing.assert_array_equal(a, b)
    got, want = TC.calibrate_epa(spec_t), RC.calibrate_epa(spec_r)
    assert got.name == want.name
    for lt, lr in zip(got.levels, want.levels):
        assert dataclasses.astuple(lt.epa) == dataclasses.astuple(lr.epa)
    with pytest.raises(ValueError, match="no levels named"):
        TC.calibrate_epa(spec_t, samples={"L9": (np.ones(4),) * 3})


# ---------------------------------------------------------------------------
# Datasets and bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPEC_NAMES)
def test_build_calibration_dataset_exact(name, small_workload, tmp_path):
    got = TC.build_calibration_dataset(_t_layers(small_workload.layers),
                                       spec=PORT_SPECS[name], n_per_layer=6,
                                       seed=1)
    want = RC.build_calibration_dataset(list(small_workload.layers),
                                        spec=REF_SPECS[name], n_per_layer=6,
                                        seed=1)
    assert got.spec_name == want.spec_name and len(got) == len(want) > 0
    for field in ("features", "analytical", "target", "layer_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    # Saved by one package, loaded by the other, both ways.
    got.save(tmp_path / "port.npz")
    want.save(tmp_path / "ref.npz")
    for a, b in ((RC.CalibrationDataset.load(tmp_path / "port.npz"), want),
                 (TC.CalibrationDataset.load(tmp_path / "ref.npz"), got)):
        assert a.spec_name == b.spec_name
        for field in ("features", "analytical", "target", "layer_idx"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_calibration_bundle_both_directions(small_workload, tmp_path):
    layers_r = list(small_workload.layers)
    spec_r, spec_t = REF_SPECS["edge3"], PORT_SPECS["edge3"]
    probe = RC.build_calibration_dataset(layers_r, spec=spec_r,
                                         n_per_layer=4, seed=1)
    # The reference's bundle in the port ...
    cr = RC.calibrate(spec_r, layers_r, n_per_layer=8, epochs=5)
    cr.save(tmp_path / "ref")
    ct = TC.Calibration.load(spec_t, tmp_path / "ref", device="cpu")
    assert ct.metrics == cr.metrics
    for lt, lr in zip(ct.spec.levels, cr.spec.levels):
        assert dataclasses.astuple(lt.epa) == dataclasses.astuple(lr.epa)
    np.testing.assert_allclose(
        ct.model.predict_latency(probe.features, probe.analytical),
        cr.model.predict_latency(probe.features, probe.analytical),
        rtol=1e-5)
    with pytest.raises(ValueError, match="base spec"):
        TC.Calibration.load(PORT_SPECS["gemmini"], tmp_path / "ref",
                            device="cpu")
    # ... and the port's in the reference.
    cp = TC.calibrate(spec_t, _t_layers(layers_r), n_per_layer=8, epochs=5,
                      device="cpu")
    assert cp.metrics["n_samples"] == cr.metrics["n_samples"]
    assert cp.metrics["spearman_analytical"] == \
        cr.metrics["spearman_analytical"]
    cp.save(tmp_path / "port")
    back = RC.Calibration.load(spec_r, tmp_path / "port")
    assert back.metrics == cp.metrics
    for lb, lp in zip(back.spec.levels, cp.spec.levels):
        assert dataclasses.astuple(lb.epa) == dataclasses.astuple(lp.epa)
    np.testing.assert_allclose(
        back.model.predict_latency(probe.features, probe.analytical),
        cp.model.predict_latency(probe.features, probe.analytical),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# Searching through the learned model
# ---------------------------------------------------------------------------

def _carried(ref_model, tmp_path, tag):
    """A reference-trained model in the port, through its npz file."""
    path = tmp_path / f"{tag}.npz"
    ref_model.save(path)
    return TSur.TrainedModel.load(path, device="cpu")


@pytest.fixture(scope="module")
def gemmini_models(small_workload, tmp_path_factory):
    """(reference, port) residual and direct models on Gemmini, trained
    by the reference on its calibration set of `small_workload`."""
    ds = RC.build_calibration_dataset(list(small_workload.layers),
                                      spec=REF_SPECS["gemmini"],
                                      n_per_layer=12, seed=0)
    out = {}
    tmp = tmp_path_factory.mktemp("models")
    for kind in ("residual", "direct"):
        if kind == "residual":
            m = RSur.train_residual_model(ds.features, ds.analytical,
                                          ds.target, epochs=30)
        else:
            m = RSur.train_direct_model(ds.features, ds.target, epochs=30)
        out[kind] = (m, _carried(m, tmp, kind))
    return out


@pytest.mark.parametrize("kind", ["residual", "direct"])
@pytest.mark.parametrize("mode", ["iterative", "softmax"])
def test_search_loss_and_gradient_with_surrogate(mode, kind, gemmini_models,
                                                 small_workload):
    ref_m, port_m = gemmini_models[kind]
    rc = r_compile(REF_SPECS["gemmini"])
    f, orders = random_population(rc, small_workload.dims_array(), 3,
                                  seed=2, continuous=True)
    theta = np.where(rc.free_mask[None, None], np.log(f), 0.0) \
        .astype(np.float32)
    r_loss = RSearch._make_loss_fn(small_workload, RSearch.SearchConfig(
        ordering_mode=mode, surrogate=ref_m))[0]
    val_r, g_r = jax.jit(jax.vmap(jax.value_and_grad(r_loss)))(
        jnp.asarray(theta), jnp.asarray(orders))
    t_loss = TSearch._make_loss_fn(
        port_workload(small_workload),
        TSearch.SearchConfig(ordering_mode=mode, surrogate=port_m), "cpu")[0]
    th_t, o_t = convert.population_from_numpy(theta, orders, device="cpu")
    np.testing.assert_allclose(t_loss(th_t, o_t).numpy(), np.asarray(val_r),
                               rtol=1e-5)
    g_t = TSearch._loss_grad(t_loss)(th_t, o_t).numpy()
    g_r = np.asarray(g_r)
    for p in range(3):
        scale = np.abs(g_r[p]).max()
        np.testing.assert_allclose(g_t[p], g_r[p], rtol=1e-4,
                                   atol=1e-5 * scale)


def test_predicted_edp_fn(gemmini_models, small_workload):
    from repro.core.cosa import cosa_map_workload
    from repro.core.arch import GEMMINI_DEFAULT as R_HW
    ref_m, port_m = gemmini_models["residual"]
    maps = cosa_map_workload(list(small_workload.layers), R_HW)
    wl_t = port_workload(small_workload)
    for pe_dim in (None, 16):
        want = RC.predicted_edp_fn(ref_m, REF_SPECS["gemmini"],
                                   pe_dim=pe_dim)(maps, small_workload)
        got = TC.predicted_edp_fn(port_m, PORT_SPECS["gemmini"],
                                  pe_dim=pe_dim)([_t_map(m) for m in maps],
                                                 wl_t)
        np.testing.assert_allclose(got, want, rtol=1e-5)


_SEARCH = dict(steps=10, round_every=5, n_start_points=3, seed=0)


def test_search_through_surrogate(gemmini_models, small_workload):
    """The co-search descending through the carried residual model with
    the predicted EDP as its oracle: the port's fused and host-batched
    engines (population 2, so the second chunk is padded) against the
    reference's, and against each other."""
    ref_m, port_m = gemmini_models["residual"]
    ref_cfg = RSearch.SearchConfig(
        surrogate=ref_m, latency_model=RC.predicted_edp_fn(ref_m), **_SEARCH)
    port_cfg = TSearch.SearchConfig(
        surrogate=port_m, latency_model=TC.predicted_edp_fn(port_m),
        **_SEARCH)
    wl_t = port_workload(small_workload)
    got = {fused: TSearch.dosa_search(wl_t, port_cfg, population=2,
                                      fused=fused, device="cpu")
           for fused in (True, False)}
    for fused in (True, False):
        want = RSearch.dosa_search(small_workload, ref_cfg, population=2,
                                   fused=fused)
        g = got[fused]
        assert g.n_evals == want.n_evals
        assert [n for n, _ in g.history] == [n for n, _ in want.history]
        np.testing.assert_allclose(g.best_edp, want.best_edp, rtol=1e-5)
        np.testing.assert_allclose(g.start_edps, want.start_edps, rtol=1e-5)
        assert_mappings_equal(g.best_mappings, want.best_mappings)
    a, b = got[True], got[False]
    assert (a.best_edp, a.n_evals, a.history, a.start_edps) == \
        (b.best_edp, b.n_evals, b.history, b.start_edps)
    assert_mappings_equal(a.best_mappings, b.best_mappings)


def test_second_surrogate_gets_its_own_engine(gemmini_models,
                                              small_workload):
    """Engines are cached per surrogate: a second model builds a new
    engine (its loss differs), the same model reuses the first."""
    wl_t = port_workload(small_workload)
    m1 = gemmini_models["residual"][1]
    m2 = gemmini_models["direct"][1]
    e1 = TSearch.make_fused_runner(
        wl_t, TSearch.SearchConfig(surrogate=m1), "cpu")
    e1b = TSearch.make_fused_runner(
        wl_t, TSearch.SearchConfig(surrogate=m1), "cpu")
    e2 = TSearch.make_fused_runner(
        wl_t, TSearch.SearchConfig(surrogate=m2), "cpu")
    assert e1 is e1b and e2 is not e1
    rc = r_compile(REF_SPECS["gemmini"])
    f, orders = random_population(rc, small_workload.dims_array(), 2, seed=4)
    th = np.where(rc.free_mask[None, None], np.log(f), 0.0)
    th_t, o_t = convert.population_from_numpy(th, orders, device="cpu")
    assert not torch.equal(e1.grad_fn(th_t, o_t), e2.grad_fn(th_t, o_t))
