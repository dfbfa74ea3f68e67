"""The port's static-analysis suite (`repro_torch.analysis`) on the CPU:
the shared lint rules give the reference's findings on the same
sources, each torch rule fires on its fixture and stays silent on its
negative fixture, the baseline ratchet, the device scopes resolve, the
port's tree lints clean, the spec lint gives the reference's rule IDs,
the device contracts on toy functions and on the real search, fleet
and serving engines, and the CLI."""
import dataclasses
import itertools
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import astlint as ref_astlint
from repro.core import archspec as ref_archspec
from repro.analysis.speclint import lint_spec as ref_lint_spec
from repro_torch.analysis import astlint, contracts, report
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.rules import DEVICE_SCOPES, RULES
from repro_torch.analysis.speclint import SpecLintError, lint_spec
from repro_torch.core import archspec as port_archspec
from repro_torch.core import fleet, search
from repro_torch.core.lru import LRUCache
from repro_torch.core.problem import Layer, Workload

ROOT = Path(__file__).resolve().parents[1]
DEVICE_FILE = "src/repro_torch/core/search.py"


def _lint(src: str, path: str = "src/repro_torch/core/x.py"):
    return astlint.lint_source(textwrap.dedent(src), path)


def _rules(violations):
    return sorted(v.rule for v in violations)


def _key(v):
    return (v.rule, v.line, v.col, v.scope, v.snippet)


# ---------------------------------------------------------------------------
# The shared rules: the port's lint equals the reference's
# ---------------------------------------------------------------------------

SHARED_SNIPPETS = {
    "rng_and_clock": """
        import random, time, numpy as np
        def f():
            t0 = time.perf_counter()
            x = np.random.rand(3)
            rng = np.random.default_rng()
            ok = np.random.default_rng(0)     # seeded: fine
            r = random.random()
            return x, t0, time.monotonic(), r
    """,
    "exceptions": """
        def swallows():
            try:
                risky()
            except Exception:
                return None
        def bare():
            try:
                risky()
            except:
                pass
        def reraises():
            try:
                risky()
            except Exception:
                cleanup()
                raise
        def narrow():
            try:
                risky()
            except ValueError:
                return None
    """,
    "mutable_defaults": """
        def f(xs=[], m={}, s=set(), *, k=dict()):
            return xs, m, s, k
        def g(xs=None, n=3, name="x"):
            return xs
        class A:
            def method(self, ys=list()):
                def inner(z=[]):
                    return z
                return inner(ys)
    """,
    "suppression": """
        import time
        def swallows():
            try:
                risky()
            except Exception:  # repro-lint: allow[EX301]
                return None
        def clock():
            return time.time()  # repro-lint: allow[ND202]
        def g(xs=[]):  # repro-lint: allow[PY401]
            return xs
        def h(xs=[]):  # repro-lint: allow[EX301]
            return xs
    """,
}
SHARED_PATHS = ("core/x.py", "serve/s.py", "runtime/r.py", "sharding/h.py",
                "workloads/gen.py", "obs/telemetry.py", "launch/tools.py")


@pytest.mark.parametrize("subpath", SHARED_PATHS)
@pytest.mark.parametrize("name", sorted(SHARED_SNIPPETS))
def test_shared_rules_match_the_reference(name, subpath):
    src = textwrap.dedent(SHARED_SNIPPETS[name])
    ref = ref_astlint.lint_source(src, f"src/repro/{subpath}")
    port = astlint.lint_source(src, f"src/repro_torch/{subpath}")
    assert [_key(v) for v in port] == [_key(v) for v in ref]


def test_shared_rules_fire_where_the_reference_says():
    """The parity above is not vacuous: inside the engine paths the
    clock double-fires, outside only OB601 remains, and the telemetry
    spine owns the clock."""
    src = SHARED_SNIPPETS["rng_and_clock"]
    assert _rules(_lint(src, "src/repro_torch/core/engine.py")) == [
        "ND201", "ND201", "ND201", "ND202", "ND202", "OB601", "OB601"]
    assert _rules(_lint(src, "src/repro_torch/workloads/gen.py")) == [
        "OB601", "OB601"]
    assert not _lint(src, "src/repro_torch/obs/telemetry.py")
    assert _rules(_lint(SHARED_SNIPPETS["exceptions"])) == ["EX301",
                                                            "EX301"]
    assert _rules(_lint(SHARED_SNIPPETS["mutable_defaults"])) == [
        "PY401"] * 6
    # a suppression names one rule: OB601 and h's PY401 still fire
    assert _rules(_lint(SHARED_SNIPPETS["suppression"])) == ["OB601",
                                                             "PY401"]


# ---------------------------------------------------------------------------
# The torch rules: one positive and one negative fixture each
# ---------------------------------------------------------------------------

def _in_segment(body: str) -> str:
    """`body` as the body of `FusedEngine.segment`, a device scope."""
    return ("import numpy as np, torch\n"
            "class FusedEngine:\n"
            "    def segment(self, theta, orders, best, n_steps):\n"
            + textwrap.indent(textwrap.dedent(body), " " * 8)
            + "\n        return theta\n")


def _in_host_fn(body: str) -> str:
    """The same `body` in a function no device scope names."""
    return _in_segment(body).replace("class FusedEngine", "class Driver")


TH_POSITIVE = [
    ("TH101", "n = theta.sum().item()"),
    ("TH101", "xs = theta.tolist()"),
    ("TH101", "h = theta.cpu()"),
    ("TH101", "a = theta.detach().numpy()"),
    ("TH101", "i = (theta > 0).nonzero()"),
    ("TH101", "i = torch.nonzero(theta)"),
    ("TH101", "u = torch.unique(orders)"),
    ("TH101", "m = torch.masked_select(theta, theta > 0)"),
    ("TH101", "m = theta.masked_select(theta > 0)"),
    ("TH101", "a = np.abs(theta)"),
    ("TH101", "v = float(theta.sum())"),
    ("TH101", "n = int(orders[0, 0])"),
    ("TH101", "b = bool(best.edp.isfinite().all())"),
    ("TH101", 'h = theta.to("cpu")'),
    ("TH101", 'h = theta.to(torch.device("cuda", 1))'),
    ("TH101", "h = theta.to(self.device)"),
    ("TH101", "h = theta.to(device=dev, non_blocking=True)"),
    ("TH102", "if (theta > 0).any():\n    theta = -theta"),
    ("TH102", "if torch.all(best.edp < 1):\n    theta = -theta"),
    ("TH102", "while theta.max() > 1:\n    theta = theta / 2"),
    ("TH103", "t = theta.to(torch.float64)"),
    ("TH103", "t = torch.zeros(3, dtype=torch.double)"),
    ("TH103", "t = theta.double()"),
    ("TH103", "t = torch.as_tensor(orders, dtype=np.float64)"),
    ("TH104", "p = torch.prod(theta, dim=-1)"),
    ("TH104", "p = theta.prod(-1)"),
    ("TH104", "p = torch.cumprod(theta, dim=-1)"),
    ("TH104", "p = theta.cumprod(-1)"),
]

TH_NEGATIVE = [
    # configuration values, not tensor values (core/search.py's own line)
    ("TH102", 'if self.cfg.ordering_mode in ("iterative", "softmax"):\n'
              "    theta = -theta"),
    ("TH102", "if theta.shape[-1] > 1 and len(orders):\n"
              "    theta = theta[..., :1]"),
    ("TH102", "if torch.is_grad_enabled():\n    theta = theta.detach()"),
    ("TH101", "i = torch.argmin(theta, dim=-1, keepdim=True)\n"
              "v = torch.gather(theta, -1, i)"),
    # literals and dtype casts stay on the device; a host config value
    # is suppressed inline with its reason
    ("TH101", "t = theta.to(orders.dtype) * float(2) + int('3')\n"
              "u = theta.to(theta)\n"
              "k = int(self.cfg.k)  # repro-lint: allow[TH101] config"),
    ("TH103", "t = theta.to(torch.float32)\n"
              "z = torch.zeros(3, dtype=torch.float32)"),
    ("TH104", "p = theta[..., 0] * theta[..., 1]\n"
              "n = math.prod(theta.shape)"),
]


@pytest.mark.parametrize("rule,body", TH_POSITIVE,
                         ids=[f"{r}-{i}" for i, (r, _) in
                              enumerate(TH_POSITIVE)])
def test_torch_rule_fires_in_a_device_scope(rule, body):
    vs = astlint.lint_source(_in_segment(body), DEVICE_FILE)
    assert _rules(vs) == [rule], [str(v) for v in vs]
    assert vs[0].scope == "segment"
    assert vs[0].message == RULES[rule].message
    # the same code outside every device scope is host code: silent
    assert not astlint.lint_source(_in_host_fn(body), DEVICE_FILE)
    # and so is a file no device scope names
    assert not astlint.lint_source(_in_segment(body),
                                   "src/repro_torch/core/driver.py")


@pytest.mark.parametrize("rule,body", TH_NEGATIVE,
                         ids=[f"{r}-{i}" for i, (r, _) in
                              enumerate(TH_NEGATIVE)])
def test_torch_rule_silent_on_negative_fixture(rule, body):
    assert not astlint.lint_source(_in_segment(body), DEVICE_FILE)


def test_device_scope_covers_nested_functions_and_closures():
    src = """
        import torch
        def _make_loss_fn(workload, cfg, device):
            table = torch.as_tensor(workload.dims, dtype=torch.float64)
            def loss(theta, orders):
                def inner(x):
                    return x.item()
                return inner(theta)
            return loss
    """
    vs = _lint(src, DEVICE_FILE)
    # the builder's float64 table is host set-up: not a device scope
    assert [(v.rule, v.scope) for v in vs] == [
        ("TH101", "_make_loss_fn.loss.inner")]


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------

def test_fingerprint_stable_across_line_moves():
    src = _in_segment("n = theta.sum().item()")
    a = astlint.lint_source(src, DEVICE_FILE)
    b = astlint.lint_source("\n\n# a comment shifting every line\n" + src,
                            DEVICE_FILE)
    assert a[0].fingerprint == b[0].fingerprint
    assert a[0].line != b[0].line


def test_baseline_diff_classifies(tmp_path):
    src_old = """
        def a():
            try:
                risky()
            except Exception:
                return None
    """
    src_new = """
        def a():
            try:
                risky()
            except ValueError:
                return None
        def b(xs=[]):
            return xs
    """
    p = tmp_path / "baseline.json"
    astlint.save_baseline(p, _lint(src_old))
    new, old, fixed = astlint.diff_baseline(_lint(src_new),
                                            astlint.load_baseline(p))
    assert [v.rule for v in new] == ["PY401"]   # not yet accepted
    assert old == []
    assert [e["rule"] for e in fixed] == ["EX301"]  # narrowed -> fixed
    # an accepted finding stays accepted after the line moves
    moved = "\n\n" + textwrap.dedent(src_old)
    new, old, fixed = astlint.diff_baseline(_lint(moved),
                                            astlint.load_baseline(p))
    assert (new, [v.rule for v in old], fixed) == ([], ["EX301"], [])


def test_every_fired_rule_is_in_catalog():
    fired = {v.rule for body in [b for _, b in TH_POSITIVE]
             for v in astlint.lint_source(_in_segment(body), DEVICE_FILE)}
    for src in SHARED_SNIPPETS.values():
        fired |= {v.rule for v in _lint(src, "src/repro_torch/core/e.py")}
    assert fired == set(RULES)
    for rule in RULES.values():
        assert rule.message
    # the reference's JX rules map to TH rules; JX104 has no counterpart
    assert not any(r.startswith("JX") for r in RULES)


def test_device_scopes_resolve(tmp_path):
    assert DEVICE_SCOPES
    assert astlint.unresolved_device_scopes(ROOT) == []
    # a rename in the engine shows up as an unresolved entry
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    src = (ROOT / DEVICE_FILE).read_text()
    (core / "search.py").write_text(
        src.replace("class FusedEngine:", "class FusedEngine2:"))
    gone = astlint.unresolved_device_scopes(tmp_path)
    assert (DEVICE_FILE, "FusedEngine.segment") in gone
    assert (DEVICE_FILE, "_cd_orderings") not in gone
    assert ("src/repro_torch/core/model.py", "capacities") in gone


def test_port_tree_lints_clean_against_its_baseline():
    """The gate, asserted in-suite: no new finding against the port's
    baseline, and the baseline accepts no TH finding (each is repaired
    or suppressed inline with a reason)."""
    violations = astlint.lint_paths(ROOT)
    assert all(v.path.startswith("src/repro_torch/") for v in violations)
    baseline = astlint.load_baseline(report.DEFAULT_BASELINE)
    new, _, _ = astlint.diff_baseline(violations, baseline)
    assert not new, "\n".join(str(v) for v in new)
    assert not [e for e in baseline["entries"]
                if e["rule"].startswith("TH")]


# ---------------------------------------------------------------------------
# Spec lint: the reference's malformed fixtures give its rule IDs
# ---------------------------------------------------------------------------

def _fixture(mod, case):
    def level(name="L", tensors=("W", "I", "O"), epa=None, bw=None, **kw):
        return mod.MemLevel(name, tensors, word_bytes=1.0,
                            epa=epa or mod.EpaModel(1.0),
                            bandwidth=bw or mod.BandwidthModel("const", 4.0),
                            **kw)

    def spec(levels, **kw):
        defaults = dict(name="fixture", spatial_sites=((0, 4),),
                        level0_temporal_dims=(2, 3), epa_mac=0.5,
                        max_pe_dim=16)
        defaults.update(kw)
        return mod.ArchSpec(levels=tuple(levels), **defaults)

    chain = [level("Reg", ("W",)), level("Acc", ("O",))]
    return {
        "too_few_levels": lambda: spec([level()], spatial_sites=()),
        "backing_missing_tensor": lambda: spec(
            chain + [level("DRAM", ("W", "I"))]),
        "unreachable_chain": lambda: spec(
            chain + [level("DRAM", ("W", "I", "O"))]),
        "outputs_not_two_levels": lambda: spec(
            [level("Reg", ("W", "O")), level("Acc", ("O", "I")),
             level("DRAM", ("W", "I", "O"))]),
        "negative_epa": lambda: spec(
            [level(epa=mod.EpaModel(-1.0)), level()]),
        "zero_epa": lambda: spec(
            [level(epa=mod.EpaModel(0.0, 0.0)), level()]),
        "zero_epa_mac": lambda: spec([level(), level()], epa_mac=0.0),
        "zero_bandwidth": lambda: spec(
            [level(bw=mod.BandwidthModel("const", 0.0)), level()]),
        "site_at_backing": lambda: spec([level(), level()],
                                        spatial_sites=((1, 0),)),
        "site_bad_dim": lambda: spec([level(), level()],
                                     spatial_sites=((0, 9),)),
        "dram_block_zero": lambda: spec([level(), level()],
                                        dram_block_words=0),
        "sram_round_negative": lambda: spec([level(), level()],
                                            sram_round_bytes=-8),
        "default_hw_mismatch": lambda: spec(
            [level(searched=True), level()],
            default_hw=mod.HWConfig(pe_dim=4, cap_kb=(8.0, 16.0))),
    }[case]()


SPEC_CASES = ("too_few_levels", "backing_missing_tensor", "unreachable_chain",
              "outputs_not_two_levels", "negative_epa", "zero_epa",
              "zero_epa_mac", "zero_bandwidth", "site_at_backing",
              "site_bad_dim", "dram_block_zero", "sram_round_negative",
              "default_hw_mismatch")


@pytest.mark.parametrize("case", SPEC_CASES)
def test_speclint_matches_the_reference(case):
    ref = [(i.rule, i.where) for i in
           ref_lint_spec(_fixture(ref_archspec, case))]
    port = [(i.rule, i.where) for i in
            lint_spec(_fixture(port_archspec, case))]
    assert ref, "every fixture is malformed"
    assert port == ref


def test_speclint_shipped_specs_clean_and_compile_rejects():
    for s in (port_archspec.GEMMINI_SPEC, port_archspec.TPU_V5E_SPEC,
              port_archspec.EDGE_SPEC):
        assert lint_spec(s) == []
    assert report.speclint_section()["ok"]
    with pytest.raises(SpecLintError, match="SP503"):
        port_archspec.compile_spec(_fixture(port_archspec,
                                            "unreachable_chain"))


# ---------------------------------------------------------------------------
# Contracts on toy functions
# ---------------------------------------------------------------------------

X = torch.ones(16)


def _args():
    return (X.clone(),), {}


def test_transfer_free_passes_a_pure_function():
    ok = contracts.transfer_free(lambda t: torch.tanh(t).sum(), _args)
    assert ok.passed, ok.detail


@pytest.mark.parametrize("fn,why", [
    (lambda t: t.sum().item(), "_local_scalar_dense"),
    (lambda t: bool(t.sum() > 0), "_local_scalar_dense"),
    (lambda t: t.nonzero(), "aten.nonzero"),
    (lambda t: t[t > 0], "boolean mask"),
    (lambda t: t.to("meta"), "cpu->meta"),
    (lambda t: t + torch.as_tensor(np.ones(16, np.float32)), "lift_fresh"),
], ids=["item", "bool", "nonzero", "mask", "meta_copy", "numpy_input"])
def test_transfer_free_catches_host_reads(fn, why):
    r = contracts.transfer_free(fn, _args)
    assert not r.passed and why in r.detail, r.detail
    with pytest.raises(contracts.ContractError):
        r.check()


def test_transfer_free_keeps_make_args_outside_the_guard():
    """Building the inputs from numpy is a host copy: outside the
    window (make_args) it passes, inside the call it fails."""
    host = np.ones(16, np.float32)
    assert contracts.transfer_free(
        lambda t: t * 2, lambda: ((torch.as_tensor(host),), {})).passed
    assert not contracts.transfer_free(
        lambda h: torch.as_tensor(h) * 2, lambda: ((host,), {})).passed


def test_no_f64_and_fingerprint():
    f = lambda t: torch.sqrt(t) + 1.0  # noqa: E731
    assert contracts.no_f64_constants(f, X).passed
    bad = contracts.no_f64_constants(lambda t: t.double() + 1, X)
    assert not bad.passed and "aten._to_copy" in bad.detail
    fp = contracts.trace_fingerprint(f, X)
    assert len(fp) == 16
    assert fp == contracts.trace_fingerprint(f, X.clone())
    assert fp == contracts.jaxpr_fingerprint(f, X)
    assert fp != contracts.trace_fingerprint(f, torch.ones(8))
    assert fp != contracts.trace_fingerprint(f, X.double())


def test_fingerprint_ignores_requires_grad_aliases():
    def grad(t):
        th = t.detach().requires_grad_(True)
        (g,) = torch.autograd.grad((th * th).sum(), th)
        return g
    plain = contracts.trace_fingerprint(grad, X)
    assert plain == contracts.trace_fingerprint(
        grad, X.clone().requires_grad_(True))
    # the backward's ops are recorded: a forward-only call differs
    assert plain != contracts.trace_fingerprint(lambda t: (t * t).sum(), X)


def test_prod_backward_is_seen_by_th104_not_by_the_recorder():
    """Under a dispatch mode autograd differentiates `torch.prod` by its
    subclass-safe formula, which reads nothing back, so `transfer_free`
    passes it: the blind spot TH104 covers statically."""
    def grad_of_prod(t):
        th = t.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.prod(th), th)
        return g
    assert contracts.transfer_free(grad_of_prod, _args).passed
    body = ("th = theta.detach().requires_grad_(True)\n"
            "(g,) = torch.autograd.grad(torch.prod(th), th)")
    assert _rules(astlint.lint_source(_in_segment(body),
                                      DEVICE_FILE)) == ["TH104"]


def test_compiled_programs_needs_an_engine_cache_entry():
    with pytest.raises(TypeError, match="no engine cache"):
        contracts.compiled_programs(lambda x: x)
    with pytest.raises(TypeError, match="no engine cache"):
        contracts.no_recompile(lambda x: x, ())


# ---------------------------------------------------------------------------
# Contracts on the real engines, on the CPU
# ---------------------------------------------------------------------------

WL2 = Workload(layers=(Layer.matmul(32, 64, 128, name="m2"),), name="cx2")


@pytest.fixture(scope="module")
def smoke():
    search._ENGINE_CACHE.clear(reset_stats=True)
    engine, theta, orders = report.smoke_engine_inputs("cpu")
    return engine, theta, orders


def _device_args(theta, orders, reps=1):
    return (torch.as_tensor(np.concatenate([theta] * reps)),
            torch.as_tensor(np.concatenate([orders] * reps)))


def test_search_engine_is_transfer_free_and_float32(smoke):
    engine, theta, orders = smoke
    statics = report.SEARCH_STATICS
    r = contracts.transfer_free(
        engine.run, lambda: (_device_args(theta, orders), statics))
    assert r.passed, r.detail
    assert contracts.no_f64_constants(
        engine.run, *_device_args(theta, orders), **statics).passed
    fp = contracts.trace_fingerprint(engine.run,
                                     *_device_args(theta, orders), **statics)
    assert fp == contracts.trace_fingerprint(
        engine.run, *_device_args(theta, orders), **statics)


def test_search_engine_no_recompile_across_populations(smoke):
    engine, theta, orders = smoke
    calls = [lambda: engine.run(*_device_args(theta, orders), n_full=2,
                                rem=0, seg_len=10),
             lambda: engine.run(*_device_args(theta, orders, 2), n_full=4,
                                rem=0, seg_len=5),
             lambda: search.make_fused_runner(
                 report._smoke_workload(),
                 dataclasses.replace(report._smoke_cfg(), seed=3), "cpu")]
    r = contracts.no_recompile(engine, calls)
    assert r.passed, r.detail
    assert contracts.compiled_programs(engine) == 1
    assert contracts.compiled_programs(engine.run) == 1
    contracts.assert_no_recompile(engine)


def test_second_workload_is_a_second_build(smoke):
    engine, _, _ = smoke
    cfg = report._smoke_cfg()
    r = contracts.no_recompile(
        engine, [lambda: search.make_fused_runner(WL2, cfg, "cpu")])
    assert not r.passed
    assert "built 2 time(s)" in r.detail and "1 other" in r.detail
    assert contracts.no_recompile(engine, (), expected=1).passed
    # the new workload's engine is its own entry, built once
    assert contracts.compiled_programs(
        search.make_fused_runner(WL2, cfg, "cpu")) == 1
    with pytest.raises(contracts.ContractError):
        contracts.assert_no_recompile(
            engine, [lambda: search.make_fused_runner(
                WL2, report._smoke_cfg(lr=0.5), "cpu")])


def test_engine_rebuilt_after_eviction_counts_twice():
    cache = search._ENGINE_CACHE
    cfg = report._smoke_cfg(lr=0.25)
    engine = search.make_fused_runner(WL2, cfg, "cpu")
    key = cache.key_of(engine)
    cache.discard(key)
    rebuilt = search.make_fused_runner(WL2, cfg, "cpu")
    assert rebuilt is not engine
    assert contracts.compiled_programs(rebuilt) == 2
    assert not contracts.no_recompile(rebuilt).passed


def test_contracts_section_on_cpu():
    """The report's smoke — search, fleet and service — on the CPU."""
    fleet._FLEET_ENGINE_CACHE.clear(reset_stats=True)
    sec = report.contracts_section("cpu")
    assert sec["device"] == "cpu"
    checks = sec["checks"]
    assert set(checks) == {
        "search.transfer_free", "search.sharded_transfer_free",
        "search.no_recompile", "search.no_f64_constants",
        "search.trace_fingerprint", "fleet.no_recompile",
        "fleet.transfer_free", "fleet.sharded_transfer_free",
        "serve.no_recompile"}
    failed = {k: v for k, v in checks.items()
              if isinstance(v, dict) and not v["passed"]}
    assert not failed and sec["ok"]
    assert len(checks["search.trace_fingerprint"]) == 16


def _key_with_seed(monkeypatch):
    key = search._engine_key
    monkeypatch.setattr(search, "_engine_key",
                        lambda wl, cfg, *a: key(wl, cfg, *a) + (cfg.seed,))


def _key_per_lookup(monkeypatch):
    key, n = search._engine_key, itertools.count()
    monkeypatch.setattr(search, "_engine_key",
                        lambda *a: key(*a) + (next(n),))


def _fleet_lookups_miss(monkeypatch):
    monkeypatch.setattr(fleet._FLEET_ENGINE_CACHE, "get",
                        lambda key, default=None: default)


@pytest.mark.parametrize("part,plant", [
    ("search", _key_with_seed), ("search", _key_per_lookup),
    ("serve", _key_per_lookup), ("fleet", _fleet_lookups_miss)],
    ids=["search-seed-in-key", "search-key-per-lookup",
         "serve-key-per-lookup", "fleet-lookups-miss"])
def test_report_no_recompile_sees_an_unstable_key(monkeypatch, part, plant):
    """Each report check fails when dosa_search's, the service's or the
    second fleet run's engine lookup misses the engine it was given."""
    monkeypatch.setattr(search, "_ENGINE_CACHE", LRUCache(maxsize=16))
    monkeypatch.setattr(fleet, "_FLEET_ENGINE_CACHE", LRUCache(maxsize=16))
    run = getattr(report, f"_{part}_contracts")
    cpu = torch.device("cpu")
    assert run(cpu)[f"{part}.no_recompile"]["passed"]
    plant(monkeypatch)
    r = run(cpu)[f"{part}.no_recompile"]
    assert not r["passed"] and "other engine build" in r["detail"], r


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_lint_only_writes_the_report(tmp_path, capsys):
    out = tmp_path / "analysis_report_torch.json"
    assert cli_main(["--root", str(ROOT), "--no-contracts",
                     "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and "contracts" not in rep
    assert rep["lint"]["new"] == []
    assert set(rep["spec_lint"]["specs"]) == {"gemmini", "tpu_v5e", "edge3"}
    assert "analysis: OK" in capsys.readouterr().out


def test_cli_write_baseline_and_new_finding(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text("def f(xs=[]):\n    return xs\n")
    base = tmp_path / "baseline.json"
    assert cli_main(["--root", str(tmp_path), "--baseline", str(base),
                     "--write-baseline"]) == 0
    assert [e["rule"] for e in json.loads(base.read_text())["entries"]] \
        == ["PY401"]
    out = tmp_path / "r.json"
    args = ["--root", str(tmp_path), "--baseline", str(base),
            "--no-contracts", "--out", str(out)]
    assert cli_main(args) == 0
    (pkg / "y.py").write_text("import time\nT = time.time()\n")
    assert cli_main(args) == 1
    assert [v["rule"] for v in json.loads(out.read_text())["lint"]["new"]] \
        == ["ND202", "OB601"]


def test_cli_default_device_raises_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["--root", str(ROOT), "--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
