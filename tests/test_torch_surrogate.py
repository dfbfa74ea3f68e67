"""The port's learned latency models (`repro_torch.core.surrogate`)
against the reference's (`repro.core.surrogate`): the Gemmini
featurizer and the Spearman metric exactly; the MLP forward pass with
the reference's weights carried across; `_fit` started from the
reference's initial weights; the `.npz` format in both directions.

Tolerances.  The MLP is float32 matrix products summed in another
order by XLA and by torch: rtol 1e-5.  Training is 20 epochs of Adam on
those products, and Adam divides by the root of the gradient's second
moment, which magnifies last-place differences where a gradient is
small: every validation MSE and the final predictions within rtol 1e-3
(a scratch run shows about 1e-6)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import surrogate as R
from repro.core.arch import GEMMINI_DEFAULT as R_HW
from repro.core.mapping import random_mapping
from repro.core.rtl_sim import build_dataset
from repro.workloads.dnn_zoo import alexnet
from repro_torch import convert
from repro_torch.core import surrogate as T
from repro_torch.core.arch import GemminiHW
from repro_torch.core.mapping import Mapping
from repro_torch.core.problem import Layer

T_HW = GemminiHW(pe_dim=R_HW.pe_dim, acc_kb=R_HW.acc_kb, sp_kb=R_HW.sp_kb)


def _ref_init(seed, n_in=R.N_FEATURES):
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in R.init_mlp(jax.random.PRNGKey(seed), n_in=n_in)]


@pytest.fixture(scope="module")
def dataset():
    """(features, analytical, rtl) of 90 random mappings of three
    AlexNet layers, labelled by the reference's RTL stand-in."""
    feats, ana, rtl, _ = build_dataset(list(alexnet().layers)[:3], R_HW,
                                       n_per_layer=30, seed=0)
    return feats, ana, rtl


def test_constants_and_featurize_exact():
    assert T.N_FEATURES == R.N_FEATURES
    assert (T.N_HIDDEN_LAYERS, T.HIDDEN) == (R.N_HIDDEN_LAYERS, R.HIDDEN)
    assert (T.RESIDUAL_CLIP, T.DIRECT_CLIP) == (R.RESIDUAL_CLIP,
                                                R.DIRECT_CLIP)
    np.testing.assert_array_equal(T.FREE_MASK, R.FREE_MASK)
    lay_r = alexnet().layers[2]
    lay_t = Layer(dims=tuple(lay_r.dims), wstride=lay_r.wstride,
                  hstride=lay_r.hstride, repeat=lay_r.repeat)
    rng = np.random.default_rng(7)
    for _ in range(10):
        m = random_mapping(np.asarray(lay_r.dims), rng,
                           max_pe_dim=R_HW.pe_dim)
        got = T.featurize(Mapping(f=m.f.copy(), order=m.order.copy()),
                          lay_t, T_HW)
        want = R.featurize(m, lay_r, R_HW)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_featurize_rejects_non_gemmini_targets():
    from repro_torch.core.archspec import HWConfig
    lay = alexnet().layers[2]
    m3 = Mapping(f=np.ones((2, 3, 7)), order=np.zeros(3, dtype=np.int64))
    with pytest.raises(ValueError, match="Gemmini-only"):
        T.featurize(m3, Layer(dims=tuple(lay.dims)),
                    HWConfig(pe_dim=16, cap_kb=(256.0,)))


def test_mlp_forward_with_carried_weights():
    params_r = R.init_mlp(jax.random.PRNGKey(1))
    params_t = convert.surrogate_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in params_r],
        device="cpu")
    assert T.n_params(params_t) == R.n_params(params_r)
    x = np.random.default_rng(2).normal(size=(64, R.N_FEATURES)) \
        .astype(np.float32)
    want = np.asarray(R.mlp_apply(params_r, x))
    got = T.mlp_apply(params_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # The module keeps the same (in, out) weights, viewed from one
    # flat parameter, and computes the same function.
    net = T.MLP(params_t)
    assert net.sizes == (R.N_FEATURES,) + (R.HIDDEN,) * R.N_HIDDEN_LAYERS \
        + (1,)
    for p, q in zip(net.params, params_r):
        np.testing.assert_array_equal(p["w"].detach().numpy(),
                                      np.asarray(q["w"]))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-6)


def test_init_mlp_is_seeded_and_device_independent():
    a = T.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    b = T.init_mlp(torch.Generator().manual_seed(0), device="cpu")
    assert len(a) == 8
    assert T.n_params(a) == R.n_params(R.init_mlp(jax.random.PRNGKey(0)))
    for p, q in zip(a, b):
        assert torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"])


def test_surrogate_params_from_numpy_checks_shapes():
    good = _ref_init(0)
    with pytest.raises(ValueError, match="chain"):
        convert.surrogate_params_from_numpy(
            [good[0], {"w": good[1]["w"][:5], "b": good[1]["b"]}],
            device="cpu")
    with pytest.raises(ValueError, match="outputs"):
        convert.surrogate_params_from_numpy(good[:-1], device="cpu")


@pytest.mark.parametrize("kind", ["residual", "direct"])
def test_fit_from_reference_init(kind, dataset):
    """20 epochs from the reference's initial weights, 4 minibatches of
    16 an epoch: every validation MSE the callback sees and the final
    predictions agree."""
    feats, ana, rtl = dataset
    seed = 3
    kw = dict(epochs=20, seed=seed, batch_size=16)
    seen_r, seen_t = [], []
    if kind == "residual":
        mr = R.train_residual_model(
            feats, ana, rtl, eval_callback=lambda e, p, v: seen_r.append(
                (e, v)), **kw)
        mt = T.train_residual_model(
            feats, ana, rtl, eval_callback=lambda e, p, v: seen_t.append(
                (e, v)), init_params=_ref_init(seed), device="cpu", **kw)
    else:
        mr = R.train_direct_model(
            feats, rtl, eval_callback=lambda e, p, v: seen_r.append(
                (e, v)), **kw)
        mt = T.train_direct_model(
            feats, rtl, eval_callback=lambda e, p, v: seen_t.append(
                (e, v)), init_params=_ref_init(seed), device="cpu", **kw)
    assert [e for e, _ in seen_t] == [e for e, _ in seen_r] == \
        [0, 5, 10, 15, 19]
    np.testing.assert_allclose([v for _, v in seen_t],
                               [v for _, v in seen_r], rtol=1e-3)
    assert mt.kind == mr.kind == kind
    np.testing.assert_array_equal(mt.x_mean, mr.x_mean)
    np.testing.assert_array_equal(mt.x_std, mr.x_std)
    np.testing.assert_allclose(mt.val_mse, mr.val_mse, rtol=1e-3)
    np.testing.assert_allclose(mt.predict_latency(feats, ana),
                               mr.predict_latency(feats, ana), rtol=1e-3)


def test_fit_keeps_best_validation_params(dataset):
    """Early stopping: the returned model is the one with the least
    validation MSE the callback saw, and predicts with those weights."""
    feats, ana, rtl = dataset
    seen = []
    m = T.train_residual_model(
        feats, ana, rtl, epochs=16, seed=0, batch_size=16, device="cpu",
        eval_callback=lambda e, p, v: seen.append((v, p)))
    best_v, best_p = min(seen, key=lambda vp: vp[0])
    assert m.val_mse == best_v
    for p, q in zip(m.params, best_p):
        assert torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"])


def test_trained_model_npz_both_directions(dataset, tmp_path):
    feats, ana, rtl = dataset
    mr = R.train_residual_model(feats, ana, rtl, epochs=5, seed=1,
                                spec_name="gemmini")
    mr.save(tmp_path / "ref.npz")
    mt = T.TrainedModel.load(tmp_path / "ref.npz", device="cpu")
    assert (mt.kind, mt.spec_name, mt.val_mse, mt.n_features) == \
        (mr.kind, mr.spec_name, mr.val_mse, mr.n_features)
    assert mt.device == torch.device("cpu")
    for p, q in zip(mt.params, mr.params):
        np.testing.assert_array_equal(p["w"].numpy(), np.asarray(q["w"]))
        np.testing.assert_array_equal(p["b"].numpy(), np.asarray(q["b"]))
    np.testing.assert_allclose(mt.predict_latency(feats, ana),
                               mr.predict_latency(feats, ana), rtol=1e-5)
    # ... and back: the port's file loads in the reference unchanged.
    mt.save(tmp_path / "port.npz")
    back = R.TrainedModel.load(tmp_path / "port.npz")
    for p, q in zip(back.params, mr.params):
        np.testing.assert_array_equal(np.asarray(p["w"]), np.asarray(q["w"]))
    np.testing.assert_array_equal(back.x_mean, mr.x_mean)
    assert (back.kind, back.spec_name, back.val_mse) == \
        (mr.kind, mr.spec_name, mr.val_mse)
    np.testing.assert_array_equal(back.predict_latency(feats, ana),
                                  mr.predict_latency(feats, ana))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_and_ranks_exact(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=50)
    b = a + rng.normal(scale=0.5, size=50)
    # Ties: rounded copies share ranks.
    at, bt = np.round(a, 0), np.round(b, 1)
    for x, y in ((a, b), (at, bt), (at, at), (np.ones(5), np.arange(5.0))):
        assert T.spearman(x, y) == R.spearman(x, y)
        assert T.spearman(y, x) == T.spearman(x, y)
        np.testing.assert_array_equal(T._average_ranks(x),
                                      R._average_ranks(x))
