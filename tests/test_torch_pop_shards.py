"""Population sharding in the port (`SearchConfig.shards` over a "pop"
device mesh) against the reference's own sharded engines.

The reference shards its fused search and fleet under `shard_map`; jax
0.9's varying-axes check rejects those programs as written (a scan
carry of `core/search.py:_cd_orderings` is not varying over "pop"), so
one module fixture runs them in a subprocess over eight host devices
with `get_shard_map` replaced, from outside the package, by
``partial(jax.shard_map, check_vma=False)``: the reference test's
two-layer workload, 40 steps, rounding every 20, 4 starts, seed 3.
The port runs the same searches over repeated ``"cpu"`` devices, each
shard on its own thread, and must report the same `best_edp`, `n_evals`
and `history` exactly, the same rounded read-back bit for bit (model
EDP within rtol 1e-5), and the same reduced best."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import PORT_SPECS, port_workload
from repro import api as ref_api
from repro.core import mapping as ref_mapping
from repro.core import search as ref_search
from repro.core.problem import Layer, Workload
from repro.runtime import faults as ref_faults
from repro.serve import cosearch_service as ref_service
from repro_torch import api as port_api
from repro_torch.analysis import contracts
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.core import fleet as port_fleet
from repro_torch.core import search as port_search
from repro_torch.core.model import PopulationBest
from repro_torch.device import resolve_devices
from repro_torch.launch import mesh as port_mesh
from repro_torch.obs import telemetry as port_obs
from repro_torch.runtime import faults as port_faults
from repro_torch.serve import cosearch_service as port_service
from repro_torch.sharding import rules

WL = Workload(layers=(Layer.conv(64, 64, 3, 56, name="c1"),
                      Layer.matmul(512, 1024, 768, name="m1")),
              name="two")
BASE = dict(steps=40, round_every=20, n_start_points=4, seed=3)
SPECS = {"gemmini": None, "tpu_v5e": "tpu_v5e", "edge3": "edge3"}
# (members, requested shards) pairs for `auto_pop_shards` on 8 devices
AUTO_CASES = [(4, None), (6, None), (7, None), (12, None), (16, None),
              (4, 2), (4, 3), (4, 9), (4, 0), (8, 8)]
SRC = Path(__file__).resolve().parents[1] / "src"

_REFERENCE_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import functools
    import json
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    import repro.core.fleet as ref_fleet
    import repro.core.search as ref_search
    from repro.core.archspec import EDGE_SPEC, TPU_V5E_SPEC
    from repro.core.fleet import search_group_results
    from repro.core.model import PopulationBest
    from repro.core.problem import Layer, Workload
    from repro.core.search import (SearchConfig, dosa_search,
                                   generate_start_points,
                                   make_fused_runner,
                                   orders_from_population,
                                   shard_population, theta_from_population)
    from repro.launch.mesh import (auto_pop_shards, make_host_mesh,
                                   make_pop_mesh)
    from repro.sharding.rules import member_spec

    # jax 0.9's varying-axes check rejects the sharded engines as
    # written; they run with it off, patched from outside the package.
    _shard_map = functools.partial(jax.shard_map, check_vma=False)
    ref_search.get_shard_map = lambda: _shard_map
    ref_fleet.get_shard_map = lambda: _shard_map

    out_dir, auto_cases = sys.argv[1], json.loads(sys.argv[2])
    assert len(jax.devices()) == 8
    wl = Workload(layers=(Layer.conv(64, 64, 3, 56, name="c1"),
                          Layer.matmul(512, 1024, 768, name="m1")),
                  name="two")
    base = SearchConfig(steps=40, round_every=20, n_start_points=4,
                        seed=3)
    SPECS = {"gemmini": None, "tpu_v5e": TPU_V5E_SPEC, "edge3": EDGE_SPEC}
    summary, arrays = {}, {}

    def res(r):
        return {"best_edp": r.best_edp, "n_evals": r.n_evals,
                "history": [[int(e), float(v)] for e, v in r.history]}

    for name, spec in SPECS.items():
        for sh in (2, 4, None):
            cfg = dataclasses.replace(base, spec=spec, shards=sh)
            summary[f"search/{name}/{sh}"] = res(
                dosa_search(wl, cfg, population=4, fused=True))
        # one chunk's fused read-back from the host start points
        cfg = dataclasses.replace(base, spec=spec)
        starts, _, _ = generate_start_points(wl, cfg)
        cspec = ref_search._cspec(cfg)
        theta = np.asarray(theta_from_population(starts, cspec.free_mask),
                           dtype=np.float32)
        orders = np.asarray(orders_from_population(starts))
        arrays[f"readback/{name}/theta"] = theta
        arrays[f"readback/{name}/orders"] = orders
        run_fused = make_fused_runner(wl, cfg)[0]
        for sh in (2, 4):
            th, od = shard_population(jnp.asarray(theta),
                                      jnp.asarray(orders), sh)
            (f, o, e), best = run_fused(th, od, n_full=2, rem=0,
                                        seg_len=20, shards=sh)
            for key, val in (("f", f), ("o", o), ("edp", e),
                             ("best_edp", best.edp), ("best_f", best.f),
                             ("best_orders", best.orders)):
                arrays[f"readback/{name}/{sh}/{key}"] = np.asarray(val)

    for sp in ("random-device", "cosa-device"):
        for sh in (2, 4):
            cfg = dataclasses.replace(base, start_points=sp, shards=sh)
            summary[f"seeded/{sp}/{sh}"] = res(
                dosa_search(wl, cfg, population=4, fused=True))

    for sh in (2, 4):
        cfg = dataclasses.replace(base, shards=sh)
        summary[f"fleet/{sh}"] = [res(r) for r in search_group_results(
            wl, [TPU_V5E_SPEC, EDGE_SPEC], cfg, fused=True)]

    # the cross-shard reduction on trackers of 8 members: distinct
    # payloads tied across shards, and a tie of replicated members
    rng = np.random.default_rng(0)
    f = rng.integers(1, 9, size=(8, 2, 2, 4, 7)).astype(np.float32)
    o = rng.integers(0, 3, size=(8, 2, 4)).astype(np.int32)
    rep = np.isin(np.arange(8), [1, 4, 5, 7])
    trackers = {
        "distinct": (np.array([5, 9, 7, 3, 8, 3, 6, 3], np.float32), f, o),
        "replicated": (np.array([6, 4, 5, 8, 4, 4, 7, 4], np.float32),
                       np.where(rep[:, None, None, None, None], f[1], f),
                       np.where(rep[:, None, None], o[1], o)),
    }
    P = jax.sharding.PartitionSpec
    for tname, (edp, ff, oo) in trackers.items():
        arrays[f"reduce/{tname}/edp"] = edp
        arrays[f"reduce/{tname}/f"] = ff
        arrays[f"reduce/{tname}/orders"] = oo
        for sh in (2, 4):
            red = _shard_map(
                lambda b, sh=sh: ref_search._reduce_population_best(b, sh),
                mesh=make_pop_mesh(sh),
                in_specs=(PopulationBest(member_spec(0), member_spec(4),
                                         member_spec(2)),),
                out_specs=PopulationBest(P(), P(), P()))(
                PopulationBest(jnp.asarray(edp), jnp.asarray(ff),
                               jnp.asarray(oo)))
            for key, val in zip(("edp", "f", "orders"), red):
                arrays[f"reduce/{tname}/{sh}/{key}"] = np.asarray(val)

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return str(e)

    summary["auto"] = [outcome(lambda: auto_pop_shards(m, r))
                       for m, r in auto_cases]
    summary["pop_mesh"] = [outcome(lambda: make_pop_mesh(s).devices.size)
                           for s in (0, 1, 3, 8, 9)]
    summary["host_mesh"] = dict(make_host_mesh(2).shape)

    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
    with open(os.path.join(out_dir, "reference.json"), "w") as fh:
        json.dump(summary, fh)
""")


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's sharded engines, run once for the whole file."""
    out = tmp_path_factory.mktemp("ref_pop_shards")
    script = out / "sharded.py"
    script.write_text(_REFERENCE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script), str(out),
                        json.dumps(AUTO_CASES)],
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out / "reference.npz") as z:
        arrays = dict(z)
    return json.loads((out / "reference.json").read_text()), arrays


def _cpus(k: int) -> list[str]:
    return ["cpu"] * k


def _port_cfg(name=None, **kw):
    spec = None if SPECS.get(name) is None else PORT_SPECS[SPECS[name]]
    return port_search.SearchConfig(**BASE, spec=spec, **kw)


def _same(got, ref: dict):
    assert got.best_edp == ref["best_edp"]
    assert got.n_evals == ref["n_evals"]
    assert [[int(e), float(v)] for e, v in got.history] == ref["history"]


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

def test_mesh_resolution_matches_reference(ref_run):
    summary, _ = ref_run

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return str(e)

    eight = _cpus(8)
    assert [outcome(lambda: port_mesh.auto_pop_shards(m, r, eight))
            for m, r in AUTO_CASES] == summary["auto"]
    assert [outcome(lambda: port_mesh.make_pop_mesh(s, eight).size)
            for s in (0, 1, 3, 8, 9)] == summary["pop_mesh"]
    assert port_mesh.make_host_mesh(2, eight).shape == summary["host_mesh"]
    mesh = port_mesh.make_pop_mesh(2, eight)
    assert mesh is port_mesh.make_pop_mesh(2, _cpus(3))   # cached
    assert mesh.shape == {"pop": 2}


def test_a_single_device_is_a_one_device_mesh():
    """Several devices are opt-in: only a sequence names a mesh, so a
    single device resolves to one shard and a sequence to its entries;
    ``"cuda"`` is one card, and without a card it raises."""
    cpu = torch.device("cpu")
    assert resolve_devices("cpu") == (cpu,)
    assert resolve_devices(["cpu"] * 3) == (cpu,) * 3
    assert port_mesh.auto_pop_shards(8, None, "cpu") == 1
    assert port_mesh.auto_pop_shards(8, None, ["cpu"] * 4) == 4
    with pytest.raises(ValueError, match="names no device"):
        resolve_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_devices("cuda")


# ---------------------------------------------------------------------------
# Searches against the reference's sharded run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4, None])
@pytest.mark.parametrize("name", list(SPECS))
def test_fused_search_matches_reference_sharded_run(ref_run, name, shards):
    summary, _ = ref_run
    got = port_search.dosa_search(
        port_workload(WL), _port_cfg(name, shards=shards), population=4,
        device=_cpus(8 if shards is None else shards))
    _same(got, summary[f"search/{name}/{shards}"])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("start_points", ["random-device", "cosa-device"])
def test_device_seeded_search_matches_reference_sharded_run(
        ref_run, start_points, shards):
    """Each chunk seeded from the reference's uniforms
    (`chunk_uniforms`), as the unsharded parity test does."""
    summary, _ = ref_run
    cfg_r = ref_search.SearchConfig(**BASE, start_points=start_points)
    root = jax.random.PRNGKey(BASE["seed"])

    def chunk_uniforms(lo, n):
        u_f, u_o = ref_mapping.seed_uniforms(
            WL.dims_array(), n, jax.random.fold_in(root, lo),
            spec=ref_search._cspec(cfg_r))
        return np.asarray(u_f), np.asarray(u_o)

    got = port_search._dosa_search_fused(
        port_workload(WL), _port_cfg(start_points=start_points,
                                     shards=shards), 4, _cpus(shards),
        chunk_uniforms=chunk_uniforms)
    _same(got, summary[f"seeded/{start_points}/{shards}"])


@pytest.mark.parametrize("shards", [2, 4])
def test_fleet_group_matches_reference_sharded_run(ref_run, shards):
    summary, _ = ref_run
    got = port_fleet.search_group_results(
        port_workload(WL), [PORT_SPECS["tpu_v5e"], PORT_SPECS["edge3"]],
        _port_cfg(shards=shards), device=_cpus(shards))
    assert len(got) == 2
    for g, r in zip(got, summary[f"fleet/{shards}"]):
        _same(g, r)


# ---------------------------------------------------------------------------
# The fused read-back and the reduced best
# ---------------------------------------------------------------------------

def _run_chunk(name, theta, orders, shards):
    cfg = _port_cfg(name)
    mesh = port_mesh.make_pop_mesh(shards, _cpus(shards))
    engines = port_search.fused_engines(port_workload(WL), cfg, mesh)
    th, od = port_search.shard_population(
        torch.as_tensor(theta), torch.as_tensor(orders), shards,
        _cpus(shards))
    return port_search.run_fused(
        engines, mesh, (th, od),
        (rules.member_spec(4), rules.member_spec(2)),
        n_full=2, rem=0, seg_len=20)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(SPECS))
def test_fused_readback_matches_reference(ref_run, name, shards):
    """One chunk through the sharded engine: the rounded factors and
    orders bit for bit, the model EDP within rtol 1e-5, and the reduced
    best equal to the reference's singleton; the port's own one-shard
    run gives the same read-back and its tracker's argmin."""
    _, arrays = ref_run
    key = f"readback/{name}"
    theta, orders = arrays[f"{key}/theta"], arrays[f"{key}/orders"]
    (f, o, e), best = _run_chunk(name, theta, orders, shards)
    ref = {k: arrays[f"{key}/{shards}/{k}"]
           for k in ("f", "o", "edp", "best_edp", "best_f", "best_orders")}
    np.testing.assert_array_equal(f.numpy(), ref["f"])
    np.testing.assert_array_equal(o.numpy(), ref["o"])
    np.testing.assert_allclose(e.numpy(), ref["edp"], rtol=1e-5)
    assert best.edp.shape == (1,)
    np.testing.assert_allclose(best.edp.numpy(), ref["best_edp"],
                               rtol=1e-5)
    np.testing.assert_array_equal(best.f.numpy(), ref["best_f"])
    np.testing.assert_array_equal(best.orders.numpy(), ref["best_orders"])
    (f1, o1, e1), best1 = _run_chunk(name, theta, orders, 1)
    assert torch.equal(f1, f) and torch.equal(o1, o) and torch.equal(e1, e)
    i = int(torch.argmin(best1.edp))
    assert torch.equal(best.edp, best1.edp[i:i + 1])
    assert torch.equal(best.f, best1.f[i:i + 1])
    assert torch.equal(best.orders, best1.orders[i:i + 1])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("tracker", ["distinct", "replicated"])
def test_reduce_population_best_matches_reference(ref_run, tracker, shards):
    """Ties across shards go to the lowest shard, as the reference's
    collective decides; the tie of replicated members (a padded chunk)
    gives their shared payload."""
    _, arrays = ref_run
    key = f"reduce/{tracker}"
    full = PopulationBest(
        edp=torch.as_tensor(arrays[f"{key}/edp"]),
        f=torch.as_tensor(arrays[f"{key}/f"]),
        orders=torch.as_tensor(arrays[f"{key}/orders"]).long())
    blocks = [PopulationBest(*parts) for parts in
              zip(*(x.chunk(shards) for x in full))]
    got = port_search._reduce_population_best(blocks)
    for field, val in zip(("edp", "f", "orders"), got):
        np.testing.assert_array_equal(val.numpy(),
                                      arrays[f"{key}/{shards}/{field}"])


# ---------------------------------------------------------------------------
# Concurrency: one thread a shard, failures raised from the join
# ---------------------------------------------------------------------------

def test_each_shard_runs_on_its_own_thread():
    mesh = port_mesh.make_pop_mesh(4, _cpus(4))
    seen = []

    def fn(x):
        seen.append(threading.get_ident())
        return x * 2, x.sum()

    (y, sums) = rules.shard_map(
        fn, mesh=mesh, in_specs=(rules.member_spec(1),),
        out_specs=(rules.member_spec(1), None))(torch.arange(16.)
                                                .reshape(8, 2))
    assert torch.equal(y, torch.arange(16.).reshape(8, 2) * 2)
    assert [float(s) for s in sums] == [6.0, 22.0, 38.0, 54.0]
    assert len(set(seen)) == 4 and threading.get_ident() not in seen


def test_worker_failure_is_raised_from_the_join():
    """Every worker runs to its end; the first failure in shard order is
    the one raised, and none is swallowed."""
    mesh = port_mesh.make_pop_mesh(4, _cpus(4))
    finished = []

    def fn(x):
        i = int(x[0])
        if i in (1, 3):
            raise KeyError(f"shard {i}")
        finished.append(i)
        return x

    with pytest.raises(KeyError, match="shard 1"):
        rules.shard_map(fn, mesh=mesh, in_specs=(rules.member_spec(),),
                        out_specs=rules.member_spec())(torch.arange(4))
    assert sorted(finished) == [0, 2]
    with pytest.raises(ValueError, match="do not divide"):
        rules.shard_map(fn, mesh=mesh, in_specs=(rules.member_spec(),),
                        out_specs=rules.member_spec())(torch.arange(6))


def test_sharded_transfer_free_catches_a_worker_host_read():
    mesh = port_mesh.make_pop_mesh(2, _cpus(2))

    def make_args():
        return (torch.arange(4.),)

    ok = contracts.transfer_free_sharded(
        lambda x: x * 2, make_args, mesh, (rules.member_spec(),),
        rules.member_spec())
    assert ok.passed and "2 shards on 2 worker threads" in ok.detail
    bad = contracts.transfer_free_sharded(
        lambda x: x * float(x.sum()), make_args, mesh,
        (rules.member_spec(),), rules.member_spec())
    assert not bad.passed and "_local_scalar_dense" in bad.detail


def test_dispatch_spans_report_the_shards_used(monkeypatch):
    clock = iter(range(10**6))
    monkeypatch.setattr(port_obs, "_GLOBAL_TRACER",
                        port_obs.Tracer(clock=lambda: float(next(clock))))
    wl = port_workload(WL)
    cfg = port_search.SearchConfig(steps=2, round_every=1,
                                   n_start_points=4, seed=3)
    port_search.dosa_search(wl, cfg, population=4, device=_cpus(8))
    port_fleet.fleet_search(wl, [PORT_SPECS["tpu_v5e"],
                                 PORT_SPECS["edge3"]],
                            dataclasses.replace(cfg, shards=2),
                            device=_cpus(2))
    tracer = port_obs.get_tracer()
    assert [s.attrs["shards"] for s in
            tracer.spans_named("search.fused_dispatch")] == [4]
    assert [s.attrs["shards"] for s in
            tracer.spans_named("fleet.fused_dispatch")] == [2]


# ---------------------------------------------------------------------------
# The service's shard-loss degrade
# ---------------------------------------------------------------------------

WL_A = Workload(layers=(Layer.matmul(16, 16, 16, name="a"),), name="wa")


class _Clock:
    def __call__(self):
        return 0.0


def test_shard_loss_degrades_to_single_shard():
    """The reference's chaos test, run against both services on the
    same submission, with the shard lost at the second segment: the
    port's request runs its first segment sharded over two CPU devices,
    then replays on one shard; both answer ``degraded`` with
    ``("shard_fallback",)``, the same events and metrics, and the direct
    search's answer."""
    views = {}
    for name, api, search, service, faults, dev in (
            ("ref", ref_api, ref_search, ref_service, ref_faults, {}),
            ("port", port_api, port_search, port_service, port_faults,
             {"device": _cpus(2)})):
        fired = {"n": 0}

        def hook(task_id, seg, request_ids, faults=faults, fired=fired):
            if seg == 1 and fired["n"] == 0:
                fired["n"] += 1
                raise faults.ShardLossFault("device unreachable")

        svc = service.CoSearchService(service.ServiceConfig(
            bucket_workloads=False, clock_fn=_Clock()))
        svc.fault_hook = hook
        wl = WL_A if name == "ref" else port_workload(WL_A)
        cfg = search.SearchConfig(steps=4, round_every=2, n_start_points=2,
                                  seed=14)
        rid = svc.submit(api.SearchRequest(workload=wl, config=cfg, **dev))
        out = svc.drain()[rid]
        direct = search.dosa_search(wl, cfg, population=2, fused=True,
                                    **dev)
        assert fired["n"] == 1
        assert out.status == "degraded" and out.ok
        assert out.degraded == ("shard_fallback",)
        assert svc._tasks[0]._force_shards1
        r = out.result
        assert (r.best_edp, r.n_evals, r.history) == \
            (direct.best_edp, direct.n_evals, direct.history)
        assert svc.stats()["faults"]["degraded_requests"] == 1
        views[name] = (r.best_edp, r.n_evals, r.history,
                       [dataclasses.astuple(e) for e in svc.events(rid)],
                       svc.metrics.to_prometheus())
    assert views["port"] == views["ref"]


# ---------------------------------------------------------------------------
# Checkpoint placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["device", "mesh"])
def test_restore_places_leaves(tmp_path, placement):
    """`restore(shardings=)`: a device moves the leaf there, a (pop
    mesh, member spec) pair splits it into member blocks on the mesh's
    devices; the values are what the reference's restore reads from the
    same checkpoint."""
    from repro.checkpoint import checkpoint as ref_ckpt
    rng = np.random.default_rng(1)
    state = {"theta": rng.normal(size=(4, 2, 2, 4, 7)).astype(np.float32),
             "orders": rng.integers(0, 3, size=(4, 2, 4)),
             "meta": (np.arange(3), np.float32(2.5))}
    port_ckpt.save(tmp_path, 7, state)
    _, ref = ref_ckpt.restore(tmp_path)
    if placement == "device":
        shardings = {"theta": "cpu", "orders": torch.device("cpu"),
                     "meta": ("cpu", "cpu")}
    else:
        mesh = port_mesh.make_pop_mesh(2, _cpus(2))
        shardings = {"theta": (mesh, rules.member_spec(4)),
                     "orders": (mesh, rules.member_spec(2)),
                     "meta": ("cpu", "cpu")}
    step, got = port_ckpt.restore(tmp_path, shardings=shardings)
    assert step == 7
    for k in ("theta", "orders"):
        leaf = got[k]
        if placement == "mesh":
            assert isinstance(leaf, rules.MemberShards)
            assert [b.shape[0] for b in leaf.blocks] == [2, 2]
            assert leaf.shape == ref[k].shape
            leaf = leaf.gather()
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref[k]))
    assert [t.numpy().tolist() for t in got["meta"]] == \
        [np.asarray(x).tolist() for x in ref["meta"]]
