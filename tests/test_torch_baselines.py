"""The port's black-box baselines (`repro_torch.core.baselines`)
against the reference's: host numpy on both sides, so for a seed the
best EDP and the whole (evals, best) history are exactly equal."""
import numpy as np
import pytest

from _torch_parity import port_workload
from repro.core import baselines as R
from repro.core import hw_infer as R_hw
from repro.core.problem import Layer, Workload
from repro_torch.core import baselines as T
from repro_torch.core import hw_infer as T_hw


@pytest.fixture(scope="module")
def two_layers() -> Workload:
    return Workload(layers=(Layer.conv(32, 64, 3, 14, name="c"),
                            Layer.matmul(64, 128, 96, name="m")),
                    name="two")


@pytest.mark.parametrize("seed", [0, 3])
def test_random_search_exact(seed, two_layers):
    want = R.random_search(two_layers, n_hw=4, n_map=6, seed=seed)
    got = T.random_search(port_workload(two_layers), n_hw=4, n_map=6,
                          seed=seed)
    assert got == want
    assert np.isfinite(got[0]) and len(got[1]) == 4


def test_bayes_opt_exact(two_layers):
    kw = dict(n_hw=5, n_map=4, n_candidates=30, final_map=6, seed=1)
    want = R.bayes_opt(two_layers, **kw)
    got = T.bayes_opt(port_workload(two_layers), **kw)
    assert got == want
    assert len(got[1]) == 6


def test_gp_exact():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(12, 3)), rng.normal(size=12)
    xq = rng.normal(size=(7, 3))
    np.testing.assert_array_equal(T._GP().fit(x, y).predict(xq),
                                  R._GP().fit(x, y).predict(xq))


def test_legacy_hw_entry_points_exact(two_layers):
    """`random_hw` draws and `minimal_hw` / `minimal_hw_population`
    of the reference's CoSA mappings."""
    from repro.core.cosa import cosa_map_workload
    from repro_torch.core.mapping import Mapping

    r_rng, t_rng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(5):
        assert vars(T_hw.random_hw(t_rng)) == vars(R_hw.random_hw(r_rng))
    pop_r = [cosa_map_workload(list(two_layers.layers), R_hw.random_hw(
        np.random.default_rng(s))) for s in range(3)]
    pop_t = [[Mapping(f=m.f.copy(), order=m.order.copy()) for m in ms]
             for ms in pop_r]
    layers_t = list(port_workload(two_layers).layers)
    assert vars(T_hw.minimal_hw(pop_t[0], layers_t)) == \
        vars(R_hw.minimal_hw(pop_r[0], list(two_layers.layers)))
    assert [vars(h) for h in T_hw.minimal_hw_population(pop_t, layers_t)] \
        == [vars(h) for h in R_hw.minimal_hw_population(
            pop_r, list(two_layers.layers))]
