"""The port's telemetry spine (`repro_torch.obs`) against the
reference's (`repro.obs`): the same call sequence under an injected
fake clock gives Prometheus text that is byte-equal and span trees
equal in names, parents, attributes and times; the engine-build hooks
read the swappable module clock; the port's fused, host-batched and
fleet engines record the reference's spans for the same search; and
the npz history store reads across packages."""
import numpy as np
import pytest

from _torch_parity import PORT_SPECS, REF_SPECS, port_workload
from repro.core import fleet as ref_fleet
from repro.core import search as ref_search
from repro.core.lru import LRUCache as RefLRU
from repro.core.problem import Layer, Workload
from repro.obs import history as ref_history
from repro.obs import telemetry as ref_obs
from repro_torch.core import fleet as port_fleet
from repro_torch.core import search as port_search
from repro_torch.core.lru import LRUCache as PortLRU
from repro_torch.obs import history as port_history
from repro_torch.obs import telemetry as port_obs

WL = Workload(layers=(Layer.matmul(16, 16, 16, name="a"),
                      Layer.conv(8, 16, 3, 8, name="c")), name="wa")
SEARCH = dict(steps=6, round_every=3, n_start_points=3, seed=1)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def tick(self, dt=1.0):
        self.t += dt

    def __call__(self):
        return self.t


def _drive(obs):
    """One call sequence over the whole tracer + registry surface."""
    clk = _Clock()
    tr = obs.Tracer(clock=clk, max_spans=6)
    reg = obs.MetricsRegistry()
    c = reg.counter("serve_things_total", "things done", ("kind",))
    g = reg.gauge("queue_depth", "queued requests")
    h = reg.histogram("request_seconds", "latency", ("route",))
    reg.counter("idle_total", "never incremented")
    reg.histogram("empty_seconds", "never observed")
    with tr.span("outer", k=1) as outer:
        clk.tick()
        with tr.span("inner", label="x") as inner:
            clk.tick(2.5)
            inner.event("mark", x=3)
            inner.set(done=True)
        c.inc(kind="a")
        c.inc(2.5, kind="b")
        outer.event("after")
    root = tr.start_span("request", request_id="r1", priority=0)
    tr.add_event(root, "submitted")
    for i in range(6):
        with tr.span("segment", parent_id=root, segment=i):
            clk.tick(0.25)
            h.observe(0.001 * 10 ** i, route="/v1/search")
    h.observe(1e9, route="/v1/metrics")
    g.set(7)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("nope")
    tr.end_span(root, status="ok")
    return clk, tr, reg, root


def test_prometheus_and_span_trees_equal_reference():
    _, tr_r, reg_r, root_r = _drive(ref_obs)
    _, tr_p, reg_p, root_p = _drive(port_obs)
    assert reg_p.to_prometheus() == reg_r.to_prometheus()
    assert port_obs.render_prometheus(reg_p, reg_p) == \
        ref_obs.render_prometheus(reg_r, reg_r)
    assert reg_p.snapshot() == reg_r.snapshot()
    assert tr_p.dropped == tr_r.dropped > 0
    assert [s.to_dict() for s in tr_p.spans()] == \
        [s.to_dict() for s in tr_r.spans()]
    assert tr_p.tree(root_p) == tr_r.tree(root_r)
    assert tr_p.chrome_trace() == tr_r.chrome_trace()
    assert tr_p.total_s("segment") == tr_r.total_s("segment")


def test_disabled_tracer_and_registry_checks():
    tr = port_obs.Tracer(enabled=False)
    assert tr.span("x") is tr.span("y", a=1)
    assert tr.start_span("z") == -1 and tr.spans() == []
    reg = port_obs.MetricsRegistry()
    reg.counter("n_total", "n", ("k",))
    with pytest.raises(TypeError):
        reg.gauge("n_total")
    with pytest.raises(ValueError):
        reg.counter("n_total").inc(k="a", extra="b")
    with pytest.raises(ValueError):
        reg.counter("n_total").inc(-1.0, k="a")


def test_jsonl_export(tmp_path):
    _, tr_r, _, _ = _drive(ref_obs)
    _, tr_p, _, _ = _drive(port_obs)
    n_r = tr_r.export_jsonl(tmp_path / "r.jsonl")
    n_p = tr_p.export_jsonl(tmp_path / "p.jsonl")
    assert n_p == n_r
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()


def _fresh_globals(monkeypatch, obs, clk):
    monkeypatch.setattr(obs, "_GLOBAL_METRICS", obs.MetricsRegistry())
    monkeypatch.setattr(obs, "_GLOBAL_TRACER", obs.Tracer(clock=clk))
    monkeypatch.setattr(obs, "default_clock", clk)


def test_build_hooks_read_the_injected_clock(monkeypatch):
    out = {}
    for name, obs in (("ref", ref_obs), ("port", port_obs)):
        clk = _Clock()
        _fresh_globals(monkeypatch, obs, clk)

        def build():
            clk.tick(1.5)
            return 7

        value, secs = obs.profile_build(build, kind="fused", cache="search",
                                        label="fused:wa")
        token = obs.start_build(kind="segment", cache="fleet", label="s")
        clk.tick(0.5)
        out[name] = (value, secs, obs.finish_build(token),
                     obs.get_metrics().to_prometheus(),
                     [s.to_dict() for s in obs.get_tracer().spans()])
    assert out["port"] == out["ref"]
    assert out["port"][1:3] == (1.5, 0.5)
    # The port's setter swaps the module clock the hooks read.
    clk = _Clock()
    prev = port_obs.set_default_clock(clk)
    try:
        assert port_obs.default_clock is clk
    finally:
        port_obs.set_default_clock(prev)
    assert port_obs.default_clock is prev


def _search_spans(monkeypatch, obs, search_mod, lru_cls, run):
    clk = _Clock()
    _fresh_globals(monkeypatch, obs, clk)
    monkeypatch.setattr(search_mod, "_ENGINE_CACHE", lru_cls(maxsize=16))
    run()
    return ([s.to_dict() for s in obs.get_tracer().spans()],
            obs.get_metrics().to_prometheus())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "batched"])
def test_engine_spans_match_reference(monkeypatch, fused):
    """The same search records the same spans (names, parents, attrs)
    and the same engine-build metrics in both packages."""
    ref = _search_spans(
        monkeypatch, ref_obs, ref_search, RefLRU,
        lambda: ref_search.dosa_search(
            WL, ref_search.SearchConfig(**SEARCH), population=2,
            fused=fused))
    port = _search_spans(
        monkeypatch, port_obs, port_search, PortLRU,
        lambda: port_search.dosa_search(
            port_workload(WL), port_search.SearchConfig(**SEARCH),
            population=2, fused=fused, device="cpu"))
    assert port == ref
    names = {s["name"] for s in port[0]}
    assert "engine.build" in names
    assert ("search.fused_dispatch" in names) == fused
    assert ("search.gd_segment" in names) == (not fused)


def test_fleet_spans_match_reference(monkeypatch):
    specs = ("tpu_v5e", "edge3")
    cfg = dict(steps=4, round_every=2, n_start_points=1, seed=0)
    monkeypatch.setattr(ref_fleet, "_FLEET_ENGINE_CACHE", RefLRU(16))
    monkeypatch.setattr(port_fleet, "_FLEET_ENGINE_CACHE", PortLRU(16))
    ref = _search_spans(
        monkeypatch, ref_obs, ref_search, RefLRU,
        lambda: ref_fleet.fleet_search(
            WL, [REF_SPECS[s] for s in specs],
            ref_search.SearchConfig(**cfg)))
    port = _search_spans(
        monkeypatch, port_obs, port_search, PortLRU,
        lambda: port_fleet.fleet_search(
            port_workload(WL), [PORT_SPECS[s] for s in specs],
            port_search.SearchConfig(**cfg), device="cpu"))
    assert port == ref
    assert {"fleet.fused_dispatch", "fleet.readback", "fleet.oracle"} <= \
        {s["name"] for s in port[0]}


def test_lru_stats_schema_matches_reference():
    a, b = RefLRU(maxsize=2), PortLRU(maxsize=2)
    for cache in (a, b):
        cache.put("x", 1)
        cache.get("x")
        cache.get("y")
        cache.put("y", 2)
        cache.put("z", 3)
        cache.note_build_time("x", 0.5)
    assert b.stats() == a.stats()


def test_history_roundtrip_across_packages(tmp_path):
    rows = [dict(spec="gemmini", workload="wa", segment=i,
                 best_edp=1e12 / (i + 1),
                 factors=np.full((i + 1, 2, 4, 7), i, np.float32),
                 orders=np.zeros((i + 1, 4), np.int32),
                 request_id=f"r{i}") for i in range(3)]
    ref, port = ref_history.HistoryRecorder(2), \
        port_history.HistoryRecorder(2)
    for r in rows:
        ref.record(**r)
        port.record(**r)
    assert port.dropped == ref.dropped == 1
    port.save(tmp_path / "p.npz")
    ref.save(tmp_path / "r.npz")
    for path in ("p.npz", "r.npz"):
        for cls in (ref_history.HistoryRecorder,
                    port_history.HistoryRecorder):
            back = cls.load(tmp_path / path)
            assert back.dropped == 1
            got = back.rows()
            assert [(r.segment, r.best_edp, r.request_id) for r in got] \
                == [(r.segment, r.best_edp, r.request_id)
                    for r in port.rows()]
            for g, w in zip(got, port.rows()):
                np.testing.assert_array_equal(g.factors, w.factors)
                np.testing.assert_array_equal(g.orders, w.orders)
