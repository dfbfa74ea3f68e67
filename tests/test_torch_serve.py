"""The port's serving stack (`serve/cosearch_service.py`,
`runtime/{faults,search_checkpoint,chaos}.py`,
`checkpoint/checkpoint.py`) against the reference's, called live on
the same submissions on the CPU.

Served equals direct bit for bit (a 3-request batch padded to member
bucket 4 included), and the port's service gives the reference's
outcomes, event stream, request traces and service metrics under a
fake clock, with the same batching and fault counters.  Kill/resume,
the torn-checkpoint fallback, poison quarantine with bit-identical
siblings, deadline and segment-budget timeouts, the surrogate degrade,
dedup and the weighted round-robin order are each held to the
reference; a task checkpointed by either package's service resumes in
the other's with the reference's answer."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import PORT_SPECS, REF_SPECS, port_workload
from repro import api as ref_api
from repro.checkpoint import checkpoint as ref_ckpt
from repro.core import search as ref_search
from repro.core.problem import Layer, Workload
from repro.runtime import chaos as ref_chaos
from repro.runtime import faults as ref_faults
from repro.serve import cosearch_service as ref_service
from repro_torch import api as port_api
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.core import search as port_search
from repro_torch.runtime import chaos as port_chaos
from repro_torch.runtime import faults as port_faults
from repro_torch.runtime import search_checkpoint as port_sckpt
from repro_torch.serve import cosearch_service as port_service

WL_A = Workload(layers=(Layer.matmul(16, 16, 16, name="a"),), name="wa")
WL_B = Workload(layers=(Layer.matmul(32, 16, 8, name="b"),), name="wb")

REF = dict(api=ref_api, search=ref_search, service=ref_service,
           chaos=ref_chaos, faults=ref_faults, specs=REF_SPECS,
           wl=lambda w: w, kw={})
PORT = dict(api=port_api, search=port_search, service=port_service,
            chaos=port_chaos, faults=port_faults, specs=PORT_SPECS,
            wl=port_workload, kw={"device": "cpu"})


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cfg(pkg, seed=1, steps=4, round_every=2, **kw):
    return pkg["search"].SearchConfig(steps=steps, round_every=round_every,
                                      n_start_points=2, seed=seed, **kw)


def _req(pkg, seed=1, wl=WL_A, cfg_kw=None, **kw):
    return pkg["api"].SearchRequest(workload=pkg["wl"](wl),
                                    config=_cfg(pkg, seed, **(cfg_kw or {})),
                                    **kw, **pkg["kw"])


def _svc(pkg, **kw):
    kw.setdefault("bucket_workloads", False)
    kw.setdefault("clock_fn", _Clock())
    return pkg["service"].CoSearchService(
        pkg["service"].ServiceConfig(**kw))


def _key(out):
    r = out.result
    return (out.status, out.error, out.degraded,
            None if r is None else (r.best_edp, r.n_evals,
                                    tuple(map(tuple, r.history)),
                                    tuple(r.start_edps)))


def _direct(pkg, seed, wl=WL_A, **cfg_kw):
    r = pkg["search"].dosa_search(pkg["wl"](wl), _cfg(pkg, seed, **cfg_kw),
                                  population=2, fused=True, **pkg["kw"])
    return (r.best_edp, r.n_evals, tuple(map(tuple, r.history)),
            tuple(r.start_edps))


def _stats(svc):
    st = svc.stats()
    st.pop("engine_cache")
    st.pop("fleet_engine_cache")
    return st


def _run_both(make_reqs, svc_kw=None, hook=None):
    """Submit the same requests to both packages' services and drain.
    Returns {pkg name: (service, outcomes, requests)}."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        svc = _svc(pkg, **(svc_kw or {}))
        if hook is not None:
            svc.fault_hook = hook(svc)
        reqs = make_reqs(pkg)
        for r in reqs:
            svc.submit(r)
        out[name] = (svc, svc.drain(), reqs)
    return out


def _same_service_view(res, rids):
    (rs, ro, _), (ps, po, _) = res["ref"], res["port"]
    for rid in rids:
        assert _key(po[rid]) == _key(ro[rid])
        assert [dataclasses.astuple(e) for e in ps.events(rid)] == \
            [dataclasses.astuple(e) for e in rs.events(rid)]
        assert ps.request_trace(rid) == rs.request_trace(rid)
    assert _stats(ps) == _stats(rs)
    assert ps.metrics.to_prometheus() == rs.metrics.to_prometheus()
    assert ps.pareto_frontier() == rs.pareto_frontier()


# ---------------------------------------------------------------------------
# Served == direct == the reference's service
# ---------------------------------------------------------------------------

def test_batched_service_matches_direct_and_reference():
    """Three seeds in one batch (padded to member bucket 4): each answer
    is bit-identical to a direct search, and the whole service view is
    the reference's."""
    seeds = (9, 3, 5)
    res = _run_both(lambda pkg: [_req(pkg, s) for s in seeds])
    ps, po, reqs = res["port"]
    assert _stats(ps)["n_batches"] == 1
    for s, r in zip(seeds, reqs):
        assert _key(po[r.request_id])[3] == _direct(PORT, s)
        got = po[r.request_id].result
        direct = port_search.dosa_search(port_workload(WL_A),
                                         _cfg(PORT, s), population=2,
                                         device="cpu")
        assert got.best_hw == direct.best_hw
    _same_service_view(res, [r.request_id for r in reqs])


def test_mixed_spec_group_matches_reference():
    """Same structural group, different numeric tables: one fleet-engine
    task, answers equal to direct searches and to the reference's."""
    def reqs(pkg):
        return [pkg["api"].SearchRequest(
            workload=pkg["wl"](WL_B),
            config=dataclasses.replace(_cfg(pkg, 9), spec=pkg["specs"][s]),
            **pkg["kw"]) for s in ("tpu_v5e", "edge3")]
    res = _run_both(reqs)
    ps, po, port_reqs = res["port"]
    assert _stats(ps)["n_grouped_batches"] == 1
    for r, s in zip(port_reqs, ("tpu_v5e", "edge3")):
        direct = port_search.dosa_search(
            port_workload(WL_B),
            dataclasses.replace(_cfg(PORT, 9), spec=PORT_SPECS[s]),
            population=2, device="cpu")
        assert po[r.request_id].result.best_edp == direct.best_edp
        assert po[r.request_id].result.n_evals == direct.n_evals
    _same_service_view(res, [r.request_id for r in port_reqs])


def test_dedup_matches_reference():
    def reqs(pkg):
        return [_req(pkg, 19), _req(pkg, 19), _req(pkg, 19,
                                                   request_id="mine")]
    res = _run_both(reqs)
    ps, po, port_reqs = res["port"]
    assert _stats(ps)["faults"]["dedup_hits"] == 2
    assert po["mine"] is po[port_reqs[0].request_id]
    assert ps.events("mine") == ps.events(port_reqs[0].request_id)
    _same_service_view(res, [port_reqs[0].request_id])


def test_weighted_round_robin_order_matches_reference():
    order = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        svc = _svc(pkg)
        hi = _req(pkg, 15, cfg_kw={"steps": 8}, priority=5)
        lo = _req(pkg, 16, wl=WL_B, cfg_kw={"steps": 8})
        svc.submit(hi)
        svc.submit(lo)
        done = []
        while svc.busy():
            done += [ev.request_id for ev in svc.step() if ev.done]
        order[name] = done
        assert done[0] == hi.request_id
    assert order["port"] == order["ref"]


def test_bucketing_policy():
    """With bucketing on (the default), dims already on the canonical
    ladder answer exactly as a direct search; off-ladder shapes that pad
    to one canonical workload share one engine, and the padded
    problem's EDP upper-bounds the original's within the inflation
    envelope — as in the reference."""
    from repro.core.archspec import bucket_dim
    from repro_torch.core.archspec import bucket_workload

    on = Workload(layers=(Layer.matmul(64, 64, 64, name="mm"),),
                  name="ladder")
    svc = _svc(PORT, bucket_workloads=True)
    rid = svc.submit(_req(PORT, 4, wl=on))
    assert _key(svc.drain()[rid])[3] == _direct(PORT, 4, wl=on)
    offs = [Workload(layers=(Layer.conv(30, 60, 3, 27, name="x"),),
                     name="a"),
            Workload(layers=(Layer.conv(31, 62, 3, 26, name="y"),),
                     name="b")]
    assert bucket_workload(port_workload(offs[0])) == \
        bucket_workload(port_workload(offs[1]))
    svc = _svc(PORT, bucket_workloads=True)
    for s, w in zip((1, 2), offs):
        svc.submit(_req(PORT, s, wl=w))
    svc.drain()
    assert _stats(svc)["n_batches"] == 1      # one task, one engine
    # the reference test's EDP envelope, on its config (seed 9, 60 steps)
    odd = Workload(layers=(Layer.conv(30, 60, 3, 27, name="c"),),
                   name="odd")
    cfg_kw = {"steps": 60, "round_every": 20}
    svc = _svc(PORT, bucket_workloads=True)
    rid = svc.submit(_req(PORT, 9, wl=odd, cfg_kw=cfg_kw))
    served = svc.drain()[rid].result.best_edp
    direct = _direct(PORT, 9, wl=odd, **cfg_kw)[0]
    inflation = np.prod([bucket_dim(d) / d
                         for lay in odd.layers for d in lay.dims])
    assert direct * 0.999 <= served <= direct * inflation ** 2 * 1.5


# ---------------------------------------------------------------------------
# Faults, timeouts, degradation
# ---------------------------------------------------------------------------

def test_poison_quarantine_siblings_bit_identical():
    seeds = (6, 7, 8)

    def hook(svc):
        def poison(task_id, seg, request_ids):
            if target[0] in request_ids:
                raise ValueError("chaos: poison input")
        return poison

    res = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        reqs = [_req(pkg, s) for s in seeds]
        target = [reqs[-1].request_id]
        svc = _svc(pkg, backoff_base_s=0.0)
        svc.fault_hook = hook(svc)
        for r in reqs:
            svc.submit(r)
        res[name] = (svc, svc.drain(), reqs)
    ps, po, reqs = res["port"]
    bad = po[reqs[-1].request_id]
    assert bad.status == "error" and bad.error["fault_class"] == "poison"
    for s, r in zip(seeds[:2], reqs[:2]):
        assert _key(po[r.request_id])[3] == _direct(PORT, s)
    assert _stats(ps)["faults"]["quarantined"] == 1
    assert _stats(ps)["faults"]["batch_splits"] == 1
    _same_service_view(res, [r.request_id for r in reqs])


def test_retries_and_exhaustion_match_reference(tmp_path):
    """A transient fault rolls back and retries; a budget that runs out
    is contained as an error outcome in the server loop's mode."""
    for name, pkg in (("ref", REF), ("port", PORT)):
        svc = _svc(pkg, checkpoint_dir=str(tmp_path / name / "a"),
                   max_restarts=2, backoff_base_s=0.5,
                   sleep_fn=lambda s: None)
        fails = {"n": 0}

        def hook(task_id, seg, request_ids):
            if seg == 1 and fails["n"] < 2:
                fails["n"] += 1
                raise RuntimeError("injected preemption")

        svc.fault_hook = hook
        rid = svc.submit(_req(pkg, 9, cfg_kw={"steps": 6}))
        out = svc.drain()[rid]
        assert _key(out)[3] == _direct(pkg, 9, steps=6)
        svc2 = _svc(pkg, max_restarts=1, backoff_base_s=0.0)

        def always(task_id, seg, request_ids):
            raise RuntimeError("hard fault")

        svc2.fault_hook = always
        rid2 = svc2.submit(_req(pkg, 11))
        while svc2.busy():
            svc2.step(contain_fatal=True)
        if name == "ref":
            ref_view = (_key(out), svc.request_trace(rid),
                        svc.metrics.to_prometheus(),
                        _key(svc2.outcome(rid2)))
    assert (_key(out), svc.request_trace(rid), svc.metrics.to_prometheus(),
            _key(svc2.outcome(rid2))) == ref_view
    assert svc2.outcome(rid2).error["retries"] == 1


def test_deadline_and_segment_budget_timeouts_match_reference():
    views = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        clk = _Clock()
        svc = _svc(pkg, clock_fn=clk)
        slow = _req(pkg, 10, deadline_s=50.0)
        sib = _req(pkg, 11)
        budget = _req(pkg, 12, wl=WL_B, segment_budget=1)
        for r in (slow, sib, budget):
            svc.submit(r)
        svc.step()
        clk.t += 100.0
        outs = svc.drain()
        assert outs[slow.request_id].status == "timeout"
        assert outs[slow.request_id].error["reason"] == "deadline"
        assert outs[budget.request_id].error["reason"] == "segment_budget"
        assert _key(outs[sib.request_id])[3] == _direct(pkg, 11)
        views[name] = ([_key(outs[r.request_id])
                        for r in (slow, sib, budget)], _stats(svc),
                       svc.metrics.to_prometheus())
    assert views["port"] == views["ref"]


class _DummySurrogate:
    """Stands in for a trained model; the fault fires before any engine
    reads it."""


def test_surrogate_failure_degrades_to_analytical():
    views = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        req = _req(pkg, 13, cfg_kw={"surrogate": _DummySurrogate()})
        fired = {"n": 0}

        def hook(task_id, seg, request_ids):
            if fired["n"] == 0:
                fired["n"] += 1
                raise pkg["faults"].SurrogateFault("surrogate blew up")

        svc = _svc(pkg)
        svc.fault_hook = hook
        rid = svc.submit(req)
        out = svc.drain()[rid]
        assert out.status == "degraded"
        assert out.degraded == ("surrogate_fallback",)
        assert _key(out)[3] == _direct(pkg, 13)
        # (the request id hashes the surrogate's identity, so traces,
        # which carry it, differ between the packages)
        views[name] = (_key(out), _stats(svc), svc.metrics.to_prometheus())
    assert views["port"] == views["ref"]


def test_submission_refuses_what_cannot_run():
    """``shards=2`` on one device is refused at submission with the
    reference's `auto_pop_shards` message; on two devices it runs and
    answers what a direct search answers."""
    from repro.launch.mesh import auto_pop_shards as ref_auto_pop_shards
    svc = _svc(PORT)
    with pytest.raises(ValueError) as ref:
        ref_auto_pop_shards(2, 2)        # one jax device in this process
    with pytest.raises(ValueError) as got:
        svc.submit(_req(PORT, 1, cfg_kw={"shards": 2}))
    assert str(got.value) == str(ref.value)
    two = _svc(PORT)
    rid = two.submit(port_api.SearchRequest(
        workload=port_workload(WL_A), config=_cfg(PORT, 5, shards=2),
        device=["cpu", "cpu"]))
    out = two.drain()[rid]
    assert out.status == "ok" and _key(out)[3] == _direct(PORT, 5)
    with pytest.raises(ValueError, match="single-target"):
        svc.submit(port_api.SearchRequest(
            workload=port_workload(WL_A), config=_cfg(PORT),
            specs=(PORT_SPECS["edge3"],), device="cpu"))
    assert not svc.busy()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            svc.submit(port_api.SearchRequest(workload=port_workload(WL_A),
                                              config=_cfg(PORT)))


# ---------------------------------------------------------------------------
# Checkpoints: kill/resume, torn files, GC, the format across packages
# ---------------------------------------------------------------------------

def test_checkpoint_kill_resume_identical(tmp_path):
    d = str(tmp_path)
    svc = _svc(PORT, checkpoint_dir=d)
    rid = svc.submit(_req(PORT, 9, cfg_kw={"steps": 6}))
    svc.step()
    del svc
    svc2 = _svc(PORT, checkpoint_dir=d)
    assert svc2.submit(_req(PORT, 9, cfg_kw={"steps": 6})) == rid
    out = svc2.drain()[rid]
    assert len(svc2.events(rid)) == 2
    assert _key(out)[3] == _direct(PORT, 9, steps=6)


def test_kill_resume_interleaved_tasks_with_chaos_monkey(tmp_path):
    reqs = [_req(PORT, 3, wl=WL_A), _req(PORT, 3, wl=WL_B)]

    def make_service():
        return _svc(PORT, checkpoint_dir=str(tmp_path), gc_completed=False)

    monkey = port_chaos.ChaosMonkey(port_chaos.ChaosConfig(seed=0))
    svc = make_service()
    for r in reqs:
        svc.submit(r)
    for _ in range(3):
        svc.step()
    assert sum(t.seg_done for t in svc._tasks) == 3
    svc = monkey.kill_resume(svc, make_service, reqs)
    outs = svc.drain()
    assert monkey.stats()["kills"] == 1
    assert _key(outs[reqs[0].request_id])[3] == _direct(PORT, 3, WL_A)
    assert _key(outs[reqs[1].request_id])[3] == _direct(PORT, 3, WL_B)


def test_torn_checkpoint_falls_back(tmp_path):
    svc = _svc(PORT, checkpoint_dir=str(tmp_path), gc_completed=False)
    rid = svc.submit(_req(PORT, 1))
    svc.step()
    task_id = svc._tasks[0].task_id
    assert port_sckpt.restore_task(tmp_path, task_id)[0] == 1
    assert port_chaos.tear_checkpoint(tmp_path, task_id, 1)
    assert port_sckpt.restore_task(tmp_path, task_id)[0] == 0
    svc2 = _svc(PORT, checkpoint_dir=str(tmp_path), gc_completed=False)
    svc2.submit(_req(PORT, 1))
    assert _key(svc2.drain()[rid])[3] == _direct(PORT, 1)
    # every step torn: a deterministic replay from scratch
    for step in (0, 1, 2):
        port_chaos.tear_checkpoint(tmp_path, task_id, step)
    assert port_sckpt.restore_task(tmp_path, task_id) is None
    svc3 = _svc(PORT, checkpoint_dir=str(tmp_path))
    svc3.submit(_req(PORT, 1))
    assert _key(svc3.drain()[rid])[3] == _direct(PORT, 1)


def test_checkpoint_gc(tmp_path):
    svc = _svc(PORT, checkpoint_dir=str(tmp_path / "a"))
    svc.submit(_req(PORT, 17))
    svc.drain()
    assert not list((tmp_path / "a").glob("task_*"))
    gc = svc.stats()["faults"]["checkpoint_gc"]
    assert gc["removed_tasks"] == 1 and gc["bytes_freed"] > 0
    root = tmp_path / "b"
    for i in range(4):
        (root / f"task_t{i}").mkdir(parents=True)
        (root / f"task_t{i}" / "arrays.npz").write_bytes(bytes(1000))
    gc = port_sckpt.CheckpointGC(root, max_bytes=2000)
    for i in range(4):
        gc.touch(f"t{i}")
    assert gc.sweep() == ["t0", "t1"]
    assert gc.stats()["bytes_freed"] == 2000


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A task checkpointed after its first segment by one package's
    service resumes in the other's and ends with the reference's
    answer."""
    pkgs = {"ref": REF, "port": PORT}
    reader = "port" if writer == "ref" else "ref"
    svc = _svc(pkgs[writer], checkpoint_dir=str(tmp_path))
    rid = svc.submit(_req(pkgs[writer], 9, cfg_kw={"steps": 6}))
    svc.step()
    del svc
    svc2 = _svc(pkgs[reader], checkpoint_dir=str(tmp_path))
    assert svc2.submit(_req(pkgs[reader], 9, cfg_kw={"steps": 6})) == rid
    out = svc2.drain()[rid]
    assert len(svc2.events(rid)) == 2          # resumed, not restarted
    assert _key(out)[3] == _direct(REF, 9, steps=6)


def test_checkpoint_module_format_both_ways(tmp_path):
    state = {"theta": np.arange(6, dtype=np.float32).reshape(2, 3),
             "recs": {"0": {"evals": np.int64(5)}},
             "layers": [np.ones(2, np.int64), np.zeros((1, 2))]}
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    port_ckpt.save(tmp_path / "p", 3, dict(state, w=bf),
                   extra_meta={"task_id": "x"})
    step, back = ref_ckpt.restore(tmp_path / "p")
    assert step == 3 and ref_ckpt.latest_step(tmp_path / "p") == 3
    np.testing.assert_array_equal(back["theta"], state["theta"])
    assert str(back["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  bf.float().numpy())
    ref_ckpt.save(tmp_path / "r", 4, {"theta": state["theta"],
                                      "w": np.asarray(back["w"])})
    step, got = port_ckpt.restore(tmp_path / "r")
    assert step == 4 and port_ckpt.latest_step(tmp_path / "r") == 4
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], bf)
    step, mine = port_ckpt.restore(tmp_path / "p")
    assert int(mine["recs"][0]["evals"]) == 5   # digit keys -> tuple
    np.testing.assert_array_equal(mine["layers"][1], state["layers"][1])
    with pytest.raises(FileNotFoundError):
        port_ckpt.restore(tmp_path / "nothing")


# ---------------------------------------------------------------------------
# Chaos schedule and fault taxonomy
# ---------------------------------------------------------------------------

def test_seeded_chaos_schedule_matches_reference(tmp_path):
    views = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        reqs = [_req(pkg, s) for s in (4, 5)]
        svc = _svc(pkg, checkpoint_dir=str(tmp_path / name),
                   max_restarts=8, backoff_base_s=0.0)
        monkey = pkg["chaos"].ChaosMonkey(pkg["chaos"].ChaosConfig(
            seed=11, p_transient=0.4, p_torn_checkpoint=0.5, max_faults=4))
        monkey.attach(svc)
        for r in reqs:
            svc.submit(r)
        outs = svc.drain()
        injected = monkey.stats()
        assert injected["transient"] + injected["torn_checkpoint"] > 0
        for s, r in zip((4, 5), reqs):
            assert _key(outs[r.request_id])[3] == _direct(pkg, s)
        views[name] = (injected, [_key(outs[r.request_id]) for r in reqs],
                       svc.stats()["faults"]["retries"])
    assert views["port"] == views["ref"]


@pytest.mark.parametrize("exc", [
    RuntimeError("x"), OSError("x"), FloatingPointError("x"),
    ValueError("x"), KeyError("x"), TypeError("x"), AttributeError("x"),
    NotImplementedError("x")], ids=lambda e: type(e).__name__)
def test_fault_taxonomy_matches_reference(exc):
    for seen in (False, True):
        assert port_faults.classify(exc, seen) == \
            ref_faults.classify(exc, seen)
    assert port_faults.fault_signature(exc) == \
        ref_faults.fault_signature(exc)
    pol_p = port_faults.RetryPolicy(max_retries=2, backoff_base_s=0.1)
    pol_r = ref_faults.RetryPolicy(max_retries=2, backoff_base_s=0.1)
    st_p, st_r = port_faults.RetryState(pol_p), ref_faults.RetryState(pol_r)
    for _ in range(4):
        assert st_p.next_action(exc) == st_r.next_action(exc)
        assert st_p.last_fault == st_r.last_fault
    assert [pol_p.backoff_s(a) for a in range(6)] == \
        [pol_r.backoff_s(a) for a in range(6)]
    clk = _Clock()
    dl = port_faults.Deadline(clk, 2.0)
    clk.t = 1.0
    assert not dl.expired() and dl.remaining() == 1.0
    clk.t = 2.0
    assert dl.expired()


def test_checkpoint_byte_count_repeats_the_reference(tmp_path,
                                                     monkeypatch):
    """The reference's `save_task` measures the step directory without
    its zero padding and reports 0 bytes (ROADMAP queue 3); the port
    repeats it, so the checkpoint metrics and spans agree."""
    from repro.obs import telemetry as ref_obs
    from repro.runtime import search_checkpoint as ref_sckpt
    from repro_torch.obs import telemetry as port_obs

    theta = np.zeros((2, 1, 2, 3, 7), np.float32)
    orders = np.zeros((2, 1, 3), np.int64)
    got = {}
    for name, obs, sckpt in (("ref", ref_obs, ref_sckpt),
                             ("port", port_obs, port_sckpt)):
        monkeypatch.setattr(obs, "_GLOBAL_METRICS", obs.MetricsRegistry())
        monkeypatch.setattr(obs, "_GLOBAL_TRACER", obs.Tracer())
        sckpt.save_task(tmp_path / name, "tid", 1, theta, orders,
                        [{"evals": np.int64(5)}])
        (span,) = obs.get_tracer().spans_named("checkpoint.save")
        got[name] = (span.attrs["bytes"],
                     obs.get_metrics().counter(
                         "checkpoint_bytes_total").value(op="save"))
        assert sckpt.dir_bytes(sckpt.task_dir(tmp_path / name, "tid")) > 0
    assert got["port"] == got["ref"] == (0, 0.0)
