"""Fleet co-search in the port (`core/fleet.py`) against the reference,
called live on the same inputs: the reference test's portfolio and
config (steps 40, round every 20, 2 starts, seed 3) give the
reference's `best_edp`, `n_evals`, `start_edps` and `history` per
(spec, workload) entry and its CSV; the fleet equals the port's
single-target search per spec; the engine-group count, the
`SpecParams` lowering, the parametric `member_edp` (rtol 1e-5) and the
`_check_cfg` rejections are the reference's; a calibrated target runs
its own engine as in the reference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (PORT_SPECS, REF_SPECS, SPEC_NAMES,
                           port_workload, random_population)
from repro.core import fleet as rf
from repro.core.problem import Layer, Workload
from repro.core.search import SearchConfig as RefConfig
from repro_torch import convert
from repro_torch.api import SearchRequest, run_request
from repro_torch.core import fleet as pf
from repro_torch.core import search as ps

PORTFOLIO = [
    Workload(layers=(Layer.conv(32, 64, 3, 28, name="c"),), name="convnet"),
    Workload(layers=(Layer.matmul(256, 512, 384, name="m"),), name="gemm"),
]
CFG = dict(steps=40, round_every=20, n_start_points=2, seed=3)
PAIRS = [(s, w.name) for w in PORTFOLIO for s in SPEC_NAMES]


@pytest.fixture(scope="module")
def results():
    ref = rf.fleet_search(PORTFOLIO, list(REF_SPECS.values()),
                          RefConfig(**CFG))
    port = pf.fleet_search([port_workload(w) for w in PORTFOLIO],
                           list(PORT_SPECS.values()),
                           ps.SearchConfig(**CFG), device="cpu")
    return ref, port


@pytest.mark.parametrize("name,wl", PAIRS,
                         ids=[f"{s}-{w}" for s, w in PAIRS])
def test_fleet_entry_matches_reference(results, name, wl):
    ref, port = results
    spec_name = REF_SPECS[name].name
    r, p = ref.entry(spec_name, wl), port.entry(spec_name, wl)
    assert p.best_edp == r.best_edp
    assert p.n_evals == r.n_evals
    assert p.start_edps == r.start_edps
    assert p.history == r.history
    assert p.best_energy == r.best_energy
    assert p.best_latency == r.best_latency
    assert dataclasses.astuple(p.best_hw) == dataclasses.astuple(r.best_hw)


def test_fleet_result_protocol_and_csv_match_reference(results):
    ref, port = results
    assert port.to_csv() == ref.to_csv()
    assert port.best_edp == ref.best_edp
    assert port.n_evals == ref.n_evals
    assert port.history == ref.history
    assert [(e.spec_name, e.workload) for e in port.frontier()] == \
        [(e.spec_name, e.workload) for e in ref.frontier()]
    assert 2 <= len(port.frontier()) < len(port.entries)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_fleet_matches_port_single_target_search(results, name):
    """The shared parametric engine descends each spec as the
    spec-specific engine does: same starts, samples and best EDP."""
    _, port = results
    spec = PORT_SPECS[name]
    wl = port_workload(PORTFOLIO[1])
    solo = ps.dosa_search(wl, ps.SearchConfig(spec=spec, **CFG),
                          population=CFG["n_start_points"], device="cpu")
    e = port.entry(spec.name, wl.name)
    assert e.start_edps == solo.start_edps
    assert e.n_evals == solo.n_evals
    assert e.best_edp == solo.best_edp


def test_host_batched_fleet_equals_fused(results):
    _, port = results
    hb = pf.fleet_search([port_workload(w) for w in PORTFOLIO],
                         list(PORT_SPECS.values()), ps.SearchConfig(**CFG),
                         fused=False, device="cpu")
    for a, b in zip(hb.entries, port.entries):
        assert (a.best_edp, a.n_evals) == (b.best_edp, b.n_evals)


def test_engine_groups_match_reference():
    wl = PORTFOLIO[0]
    rf._FLEET_ENGINE_CACHE.clear()
    rf.fleet_search(wl, list(REF_SPECS.values()),
                    RefConfig(steps=10, round_every=10, n_start_points=1,
                              seed=1))
    pf._FLEET_ENGINE_CACHE.clear()
    pf.fleet_search(port_workload(wl), list(PORT_SPECS.values()),
                    ps.SearchConfig(steps=10, round_every=10,
                                    n_start_points=1, seed=1),
                    device="cpu")
    assert len(pf._FLEET_ENGINE_CACHE) == len(rf._FLEET_ENGINE_CACHE) == 2


def test_same_group_specs_share_one_engine():
    wl = port_workload(Workload(layers=(Layer.matmul(64, 64, 64),),
                                name="m"))
    cfg = ps.SearchConfig(steps=10, round_every=10, n_start_points=1)
    pf._FLEET_ENGINE_CACHE.clear()
    r_tpu = pf.make_fleet_runner(wl, PORT_SPECS["tpu_v5e"], cfg, "cpu")
    assert pf.make_fleet_runner(wl, PORT_SPECS["edge3"], cfg, "cpu") \
        is r_tpu
    assert pf.make_fleet_runner(wl, PORT_SPECS["gemmini"], cfg, "cpu") \
        is not r_tpu
    assert len(pf._FLEET_ENGINE_CACHE) == 2


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_spec_params_and_member_edp_match_reference(name):
    ref_sp = rf.spec_params(REF_SPECS[name])
    port_sp = pf.spec_params(PORT_SPECS[name])
    for a, b in zip(port_sp, ref_sp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # member_edp of one member, and of a stacked member axis.
    wl = PORTFOLIO[0]
    cspec_r = rf.resolve_spec(REF_SPECS[name])
    f, orders = random_population(cspec_r, wl.dims_array(), 3, seed=5,
                                  continuous=True)
    strides = wl.strides_array().astype(np.float32)
    repeats = wl.repeats_array().astype(np.float32)
    sp_r = rf.stack_spec_params([ref_sp])
    sp_r1 = type(sp_r)(*(x[0] for x in sp_r))
    ref = [float(rf.member_edp(cspec_r, sp_r1, jnp.asarray(f[p]),
                               jnp.asarray(orders[p]), jnp.asarray(strides),
                               jnp.asarray(repeats))) for p in range(3)]
    sp_p = convert.spec_params_from_numpy(
        [np.stack([np.asarray(x)] * 3) for x in ref_sp], device="cpu")
    got = pf.member_edp(pf.resolve_spec(PORT_SPECS[name]), sp_p,
                        torch.from_numpy(f), torch.from_numpy(orders),
                        torch.from_numpy(strides), torch.from_numpy(repeats))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def _bad_configs(specs):
    return [dict(spec=specs["gemmini"]), dict(surrogate=object()),
            dict(latency_model=lambda m, w: 1.0),
            dict(ordering_mode="softmax")]


@pytest.mark.parametrize("case", range(7))
def test_check_cfg_rejections_match_reference(case):
    """The same bad calls raise the same ValueError message."""
    wl = PORTFOLIO[0]

    def calls(search_mod, fleet_mod, specs, wlc, **kw):
        bad = _bad_configs(specs)
        twins = [Workload(layers=(Layer.matmul(64, 64, 64),)),
                 Workload(layers=(Layer.matmul(128, 128, 128),))]
        twins = [wlc(t) for t in twins]
        S = search_mod.SearchConfig
        return [lambda c=c: fleet_mod.fleet_search(wlc(wl), list(
                    specs.values()), S(**c), **kw) for c in bad] + [
            lambda: fleet_mod.fleet_search([], list(specs.values()), S(),
                                           **kw),
            lambda: fleet_mod.fleet_search(twins, list(specs.values()),
                                           S(), **kw),
            lambda: fleet_mod.fleet_search(wlc(wl), [specs["edge3"]] * 2,
                                           S(), **kw)]

    from repro.core import search as rs
    ref_call = calls(rs, rf, REF_SPECS, lambda w: w)[case]
    port_call = calls(ps, pf, PORT_SPECS, port_workload, device="cpu")[case]
    with pytest.raises(ValueError) as r:
        ref_call()
    with pytest.raises(ValueError) as p:
        port_call()
    assert str(p.value) == str(r.value)


def test_fleet_request_and_default_device():
    wl = port_workload(PORTFOLIO[1])
    cfg = ps.SearchConfig(steps=4, round_every=2, n_start_points=1, seed=0)
    req = SearchRequest(workload=[wl], specs=(PORT_SPECS["edge3"],),
                        config=cfg, device="cpu")
    out = run_request(req)
    direct = pf.fleet_search(wl, PORT_SPECS["edge3"], cfg, device="cpu")
    assert out.result.to_csv() == direct.to_csv()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pf.fleet_search(wl, PORT_SPECS["edge3"], cfg)
    # shards=2: over two CPU devices the same answer as one shard; on
    # one device the reference's ValueError
    cfg2 = dataclasses.replace(cfg, n_start_points=2)
    one = pf.fleet_search(wl, PORT_SPECS["edge3"], cfg2, device="cpu")
    two = pf.fleet_search(wl, PORT_SPECS["edge3"],
                          dataclasses.replace(cfg2, shards=2),
                          device=["cpu", "cpu"])
    assert two.to_csv() == one.to_csv()
    assert [e.history for e in two.entries] == \
        [e.history for e in one.entries]
    with pytest.raises(ValueError, match=r"shards=2 outside 1\.\.1 "):
        pf.fleet_search(wl, PORT_SPECS["edge3"],
                        dataclasses.replace(cfg2, shards=2), device="cpu")


def test_calibrated_target_runs_its_own_engine(tmp_path):
    """A per-spec surrogate dict: the calibrated target searches through
    its learned model on its own engine, the others share the group
    engine — entry for entry the reference's."""
    from repro.core import calibration as RC
    from repro_torch.core.surrogate import TrainedModel

    wl = PORTFOLIO[1]
    cal = RC.calibrate(REF_SPECS["edge3"], list(wl.layers), n_per_layer=8,
                       epochs=5)
    cal.model.save(tmp_path / "edge3.npz")
    model = TrainedModel.load(tmp_path / "edge3.npz", device="cpu")
    cfg = dict(steps=20, round_every=10, n_start_points=2, seed=4)
    specs = ["tpu_v5e", "edge3"]
    ref = rf.fleet_search(wl, [REF_SPECS[s] for s in specs],
                          RefConfig(surrogate={"edge3": cal.model}, **cfg))
    port = pf.fleet_search(port_workload(wl), [PORT_SPECS[s] for s in specs],
                           ps.SearchConfig(surrogate={"edge3": model}, **cfg),
                           device="cpu")
    for r, p in zip(ref.entries, port.entries):
        assert (p.spec_name, p.best_edp, p.n_evals, p.history) == \
            (r.spec_name, r.best_edp, r.n_evals, r.history)
