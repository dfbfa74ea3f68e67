"""Assemble the machine-readable analysis report of the port.

One entry point, `build_report`, glues the three analysis parts
together — AST lint over ``src/repro_torch`` against the checked-in
baseline, spec lint over every shipped `ArchSpec`, and the engine
contract smoke (one engine build / transfer-free / no-f64 on the
search, fleet and serving paths, on a given device) — into one JSON
document (``analysis_report_torch.json``).

``report["ok"]`` is the gate: true iff the new-violation set is empty,
every shipped spec lints clean, and every contract holds.  Baseline
entries with no current match are reported under
``baseline_diff["fixed"]`` — the ratchet's progress ledger, not a
failure.  The port's copy of the reference's `repro.analysis.report`.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from . import astlint, contracts

DEFAULT_BASELINE = Path(__file__).with_name("analysis_baseline.json")


# ---------------------------------------------------------------------------
# Part 1+3: lint + spec lint
# ---------------------------------------------------------------------------

def lint_section(root: Path, baseline_path: Path) -> dict:
    violations = astlint.lint_paths(root)
    baseline = astlint.load_baseline(baseline_path)
    new, old, fixed = astlint.diff_baseline(violations, baseline)
    return {
        "total": len(violations),
        "by_rule": dict(sorted(Counter(v.rule for v in violations)
                               .items())),
        "new": [v.to_json() for v in new],
        "baselined": len(old),
        "baseline_diff": {
            "new": [v.fingerprint for v in new],
            "fixed": fixed,          # full baseline entries, now clean
        },
        "ok": not new,
    }


def speclint_section() -> dict:
    from ..core.archspec import EDGE_SPEC, GEMMINI_SPEC, TPU_V5E_SPEC
    from .speclint import lint_spec
    specs = {s.name: s for s in (GEMMINI_SPEC, TPU_V5E_SPEC, EDGE_SPEC)}
    issues = {name: [i.to_json() for i in lint_spec(s)]
              for name, s in specs.items()}
    return {"specs": issues,
            "ok": not any(v for v in issues.values())}


# ---------------------------------------------------------------------------
# Part 2: engine contract smoke.  Tiny seeded searches — the reference's
# workload, config and statics — enough to build each engine family once
# and prove the contracts on the real code paths.
# ---------------------------------------------------------------------------

def _smoke_workload():
    from ..core.problem import Layer, Workload
    return Workload(layers=(Layer.matmul(64, 64, 64, name="m"),),
                    name="analysis_smoke")


def _smoke_cfg(**kw):
    from ..core.search import SearchConfig
    return SearchConfig(steps=20, round_every=10, n_start_points=2,
                        seed=0, **kw)


def smoke_engine_inputs(device):
    """(engine, theta, orders) of the search smoke: the fused engine on
    `device` and its start population as host numpy (float32 theta,
    int64 orders)."""
    import numpy as np

    from ..core.archspec import GEMMINI_SPEC, compile_spec
    from ..core.search import (generate_start_points, make_fused_runner,
                               orders_from_population,
                               theta_from_population)

    wl, cfg = _smoke_workload(), _smoke_cfg()
    starts, _, _ = generate_start_points(wl, cfg)
    engine = make_fused_runner(wl, cfg, device)
    cspec = compile_spec(GEMMINI_SPEC)
    theta = np.asarray(theta_from_population(starts, cspec.free_mask),
                       dtype=np.float32)
    orders = np.asarray(orders_from_population(starts))
    return engine, theta, orders


SEARCH_STATICS = dict(n_full=2, rem=0, seg_len=10)
# The sharded and fleet transfer checks: two segments of two steps run
# every op of a chunk (Adam, rounding, ordering, best tracking, the
# per-segment stack) at a fifth of the recorded ops.
SHORT_STATICS = dict(n_full=2, rem=0, seg_len=2)


def _search_contracts(device) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from ..core.search import SEGMENT_OUT_SPECS, dosa_search
    from ..launch.mesh import make_pop_mesh
    from ..sharding.rules import member_spec

    engine, theta, orders = smoke_engine_inputs(device)
    wl, cfg = _smoke_workload(), _smoke_cfg()

    def make_args(reps: int = 1):
        # fresh device copies every call, outside any guarded window
        th = np.concatenate([theta] * reps)
        od = np.concatenate([orders] * reps)
        return (torch.as_tensor(th, device=device),
                torch.as_tensor(od, device=device)), SEARCH_STATICS

    def run(reps: int, **statics):
        (th, od), _ = make_args(reps)
        return engine.run(th, od, **statics)

    def drive(population: int):
        # dosa_search's own engine lookup, with another seed and start
        # count: fields its cache key leaves out
        return dosa_search(
            wl, dataclasses.replace(cfg, seed=population,
                                    n_start_points=population),
            population=population, device=device)

    out = {}
    out["search.transfer_free"] = contracts.transfer_free(
        engine.run, make_args).to_json()
    # one chunk split over two shards of the same device: no host read
    # in any shard's worker before the join
    mesh = make_pop_mesh(2, [device, device])
    out["search.sharded_transfer_free"] = contracts.transfer_free_sharded(
        lambda th, od: engine.run(th, od, **SHORT_STATICS),
        lambda: make_args()[0], mesh, (member_spec(4), member_spec(2)),
        (SEGMENT_OUT_SPECS, None)).to_json()
    # populations of 2 and 4, segments of 10 and 5: one engine
    calls = [lambda: run(1, **SEARCH_STATICS),
             lambda: run(2, n_full=4, rem=0, seg_len=5),
             lambda: drive(2), lambda: drive(4)]
    out["search.no_recompile"] = contracts.no_recompile(
        engine, calls).to_json()
    (th, od), statics = make_args()
    out["search.no_f64_constants"] = contracts.no_f64_constants(
        engine.run, th, od, **statics).to_json()
    out["search.trace_fingerprint"] = contracts.trace_fingerprint(
        engine.run, th, od, **statics)
    return out


def smoke_fleet_inputs(device, shards: int = 1):
    """(engine, args) of the fleet smoke: the fused fleet engine of TPU
    v5e + edge on `device` and its members' (theta, orders, SpecParams)
    on `device`, in the shard-major order of `shards` shards."""
    import dataclasses

    import numpy as np
    import torch

    from ..core.archspec import EDGE_SPEC, TPU_V5E_SPEC, resolve_spec
    from ..core.fleet import (make_fused_fleet_runner, shard_major_order,
                              spec_params, stack_spec_params)
    from ..core.search import (generate_start_points,
                               orders_from_population,
                               theta_from_population)

    wl, cfg = _smoke_workload(), _smoke_cfg()
    specs = [TPU_V5E_SPEC, EDGE_SPEC]      # one structural group
    thetas, orders, params = [], [], []
    for spec in specs:
        cspec = resolve_spec(spec)
        starts, _, _ = generate_start_points(
            wl, dataclasses.replace(cfg, spec=spec))
        thetas.append(theta_from_population(starts, cspec.free_mask))
        orders.append(orders_from_population(starts))
        params += [spec_params(cspec)] * len(starts)
    perm = shard_major_order(cfg.n_start_points, len(specs), shards)
    theta = np.concatenate(thetas).astype(np.float32)[perm]
    order = np.concatenate(orders)[perm]
    sp = stack_spec_params([params[i] for i in perm], device)
    engine = make_fused_fleet_runner(wl, specs, cfg, device)
    return engine, (torch.as_tensor(theta, device=device),
                    torch.as_tensor(order, device=device), sp)


def _fleet_contracts(device) -> dict:
    import dataclasses

    from ..core.archspec import EDGE_SPEC, TPU_V5E_SPEC
    from ..core.fleet import fleet_search, make_fused_fleet_runner
    from ..core.search import SEGMENT_OUT_SPECS
    from ..launch.mesh import make_pop_mesh
    from ..sharding.rules import member_spec

    wl, cfg = _smoke_workload(), _smoke_cfg()
    specs = [TPU_V5E_SPEC, EDGE_SPEC]      # one structural group
    fleet_search(wl, specs, cfg, fused=True, device=device)
    engine = make_fused_fleet_runner(wl, specs, cfg, device)
    # the second run, with another seed, must reuse the first's engine
    again = [lambda: fleet_search(wl, specs,
                                  dataclasses.replace(cfg, seed=1),
                                  fused=True, device=device)]
    out = {"fleet.no_recompile":
           contracts.no_recompile(engine, again).to_json()}
    out["fleet.transfer_free"] = contracts.transfer_free(
        engine.run, lambda: (smoke_fleet_inputs(device)[1],
                             SHORT_STATICS)).to_json()
    mesh = make_pop_mesh(2, [device, device])
    out["fleet.sharded_transfer_free"] = contracts.transfer_free_sharded(
        lambda *a: engine.run(*a, **SHORT_STATICS),
        lambda: smoke_fleet_inputs(device, shards=2)[1], mesh,
        (member_spec(4), member_spec(2), member_spec()),
        (SEGMENT_OUT_SPECS, None)).to_json()
    return out


def _serve_contracts(device) -> dict:
    import dataclasses

    from ..api import SearchRequest
    from ..core.archspec import bucket_workload
    from ..core.search import make_fused_runner
    from ..serve.cosearch_service import CoSearchService, ServiceConfig

    wl, cfg = _smoke_workload(), _smoke_cfg()
    engine = make_fused_runner(bucket_workload(wl), cfg, device)

    def three_requests():
        svc = CoSearchService(ServiceConfig(bucket_workloads=True))
        for seed in (0, 1, 2):
            svc.submit(SearchRequest(
                workload=wl, config=dataclasses.replace(cfg, seed=seed),
                device=device))
        bad = {rid: o.status for rid, o in svc.drain().items()
               if not o.ok}
        if bad:
            raise RuntimeError(f"requests did not complete: {bad}")

    return {"serve.no_recompile":
            contracts.no_recompile(engine, [three_requests]).to_json()}


def contracts_section(device="cuda") -> dict:
    """The three engine families' contracts on `device` (the card
    unless the caller asks for the CPU; without a GPU the default
    raises, nothing falls back)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    results: dict = {}
    for part in (_search_contracts, _fleet_contracts, _serve_contracts):
        results.update(part(dev))
    ok = all(r["passed"] for r in results.values()
             if isinstance(r, dict) and "passed" in r)
    return {"device": str(dev), "checks": results, "ok": ok}


# ---------------------------------------------------------------------------
# Glue
# ---------------------------------------------------------------------------

def build_report(root: str | Path, baseline_path: str | Path | None = None,
                 run_contracts: bool = True, device="cuda") -> dict:
    root = Path(root)
    baseline_path = Path(baseline_path or DEFAULT_BASELINE)
    report = {
        "version": 1,
        "root": str(root),
        "lint": lint_section(root, baseline_path),
        "spec_lint": speclint_section(),
    }
    if run_contracts:
        report["contracts"] = contracts_section(device)
    report["ok"] = all(report[k]["ok"] for k in
                       ("lint", "spec_lint") + (("contracts",)
                                                if run_contracts else ()))
    return report


def write_report(report: dict, out_path: str | Path) -> Path:
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1) + "\n")
    return out
