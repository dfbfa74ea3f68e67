"""Device seeding in the port (`mapping.seed_population`,
`cosa.cosa_seed_population`, `start_points="random-device"` /
`"cosa-device"`) against the reference, called live on the same inputs.

The port draws its uniforms from a `torch.Generator`, the reference
from a jax key, so parity is held on the reference's uniforms
(`repro.core.mapping.seed_uniforms`) handed to the port: the integer
factors, the log-factor carry and the orderings are equal exactly, and
a fused device-seeded search fed each chunk's reference uniforms
reports the reference's `best_edp`, `n_evals`, `start_edps` and
`history`.  The reference's two seed goldens are not used (they fail
under this jax's threefry default; ROADMAP "Reference state")."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (PORT_SPECS, REF_SPECS, SPEC_NAMES,
                           assert_search_equal, port_workload)
from repro.core import mapping as ref_mapping
from repro.core import search as ref_search
from repro.core.problem import Layer, Workload
from repro_torch.core import cosa as port_cosa
from repro_torch.core import mapping as port_mapping
from repro_torch.core import search as port_search

WL = Workload(layers=(Layer.conv(64, 64, 3, 56, name="c1"),
                      Layer.matmul(512, 1024, 768, name="m1")),
              name="two")
# The fused search: 2 segments of 10 steps, 3 start points through
# population 2, so the second chunk is seeded with one padded member.
SEARCH = dict(steps=20, round_every=10, n_start_points=3, seed=2)


def _ref_uniforms(dims, n, key, name):
    u_f, u_o = ref_mapping.seed_uniforms(dims, n, key, spec=REF_SPECS[name])
    return np.asarray(u_f), np.asarray(u_o)


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("mode", ["random", "cosa"])
def test_seed_population_matches_reference(name, mode):
    dims = WL.dims_array()
    key = jax.random.PRNGKey(7)
    f_r, th_r, o_r = ref_mapping.seed_population(dims, 5, key,
                                                 spec=REF_SPECS[name],
                                                 mode=mode)
    uniforms = _ref_uniforms(dims, 5, key, name)
    f_p, th_p, o_p = port_mapping.seed_population(
        dims, 5, spec=PORT_SPECS[name], mode=mode, device="cpu",
        uniforms=uniforms)
    np.testing.assert_array_equal(f_p.numpy(), np.asarray(f_r))
    np.testing.assert_array_equal(th_p.numpy(), np.asarray(th_r))
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_r))
    f_h, o_h = port_mapping.seed_population_host(
        dims, *uniforms, spec=PORT_SPECS[name], mode=mode)
    np.testing.assert_array_equal(f_p.numpy(), f_h)
    np.testing.assert_array_equal(o_p.numpy(), o_h)


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("mode", ["random", "cosa"])
def test_generator_seeding_is_valid_and_deterministic(name, mode):
    """The port's own stream: every seeded mapping is valid for its
    spec, spatial factors never pass the PE cap, and one generator seed
    gives one population."""
    dims = WL.dims_array()
    spec = PORT_SPECS[name]

    def draw():
        gen = torch.Generator().manual_seed(3)
        return port_mapping.seed_population(dims, 4, gen, spec=spec,
                                            mode=mode, device="cpu")

    (f, theta, o), (f2, _, o2) = draw(), draw()
    assert torch.equal(f, f2) and torch.equal(o, o2)
    assert bool(torch.isfinite(theta).all())
    fn, on = f.numpy().astype(float), o.numpy()
    for p in range(4):
        for li, m in enumerate(port_mapping.unstack_mappings(fn[p], on[p])):
            m.validate(dims[li], spec=spec)
    assert (fn[:, :, 0] <= port_search._cspec(
        port_search.SearchConfig(spec=spec)).pe_cap).all()


def test_entry_points_alias_modes():
    dims = WL.dims_array()
    uniforms = _ref_uniforms(dims, 3, jax.random.PRNGKey(1), "gemmini")
    for alias, mode in ((port_mapping.random_mapping_population, "random"),
                        (port_cosa.cosa_seed_population, "cosa")):
        a = alias(dims, 3, device="cpu", uniforms=uniforms)
        b = port_mapping.seed_population(dims, 3, mode=mode, device="cpu",
                                         uniforms=uniforms)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_seed_population_rejects_unknown_mode_and_missing_stream():
    dims = WL.dims_array()
    with pytest.raises(ValueError, match="mode"):
        port_mapping.seed_population(dims, 2, torch.Generator(),
                                     mode="exhaustive", device="cpu")
    with pytest.raises(ValueError, match="generator or uniforms"):
        port_mapping.seed_population(dims, 2, device="cpu")


def test_seeding_defaults_to_the_card():
    """Without a GPU the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        gen = torch.Generator(device="cuda").manual_seed(0)
        f, _, _ = port_mapping.seed_population(WL.dims_array(), 2, gen)
        assert f.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        port_mapping.seed_population(WL.dims_array(), 2,
                                     torch.Generator())


@pytest.mark.parametrize("name", SPEC_NAMES)
@pytest.mark.parametrize("start_points", ["random-device", "cosa-device"])
def test_device_seeded_fused_search_matches_reference(name, start_points):
    cfg_r = ref_search.SearchConfig(spec=REF_SPECS[name],
                                    start_points=start_points, **SEARCH)
    ref = ref_search.dosa_search(WL, cfg_r, population=2)
    cspec = ref_search._cspec(cfg_r)
    root = jax.random.PRNGKey(SEARCH["seed"])

    def chunk_uniforms(lo, n):
        u_f, u_o = ref_mapping.seed_uniforms(
            WL.dims_array(), n, jax.random.fold_in(root, lo), spec=cspec)
        return np.asarray(u_f), np.asarray(u_o)

    cfg_p = port_search.SearchConfig(spec=PORT_SPECS[name],
                                     start_points=start_points, **SEARCH)
    got = port_search._dosa_search_fused(port_workload(WL), cfg_p, 2,
                                         torch.device("cpu"),
                                         chunk_uniforms=chunk_uniforms)
    assert_search_equal(got, ref)
    assert got.start_edps == []


def test_device_seeded_search_own_stream():
    """Through `dosa_search` the chunks draw from `chunk_generator`:
    deterministic per seed, one stream per chunk, no start oracle
    evaluations (2 segments x 3 members + 20 GD steps x 3)."""
    wl = port_workload(WL)
    cfg = port_search.SearchConfig(start_points="random-device", **SEARCH)
    a = port_search.dosa_search(wl, cfg, population=2, device="cpu")
    b = port_search.dosa_search(wl, cfg, population=2, device="cpu")
    assert (a.best_edp, a.n_evals, a.history) == \
        (b.best_edp, b.n_evals, b.history)
    assert a.n_evals == 2 * 3 + 20 * 3 and a.start_edps == []
    g0 = port_search.chunk_generator(2, 0, "cpu")
    g2 = port_search.chunk_generator(2, 2, "cpu")
    assert not torch.equal(torch.rand(8, generator=g0),
                           torch.rand(8, generator=g2))
