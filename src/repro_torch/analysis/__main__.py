"""CLI: ``python -m repro_torch.analysis`` — run the port's
static-analysis suite and write
``$REPRO_BENCH_OUT/analysis_report_torch.json`` (beside, never over,
the reference's ``analysis_report.json``).

Exit code 0 iff every gate holds: no non-baselined lint violation, all
shipped specs lint clean, and (unless ``--no-contracts``) the engine
contracts pass on ``--device`` (``cuda`` unless the caller asks for
the CPU; without a GPU the contracts raise, nothing falls back).
``--no-contracts`` lints without touching a device.
``--write-baseline`` re-records the current lint findings as the
accepted baseline (the ratchet reset — review the diff before
committing it).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from . import astlint
from .report import DEFAULT_BASELINE, build_report, write_report


def _default_out() -> Path:
    return Path(os.environ.get("REPRO_BENCH_OUT", "bench_results")) \
        / "analysis_report_torch.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="device-hygiene static analysis of the PyTorch port: "
                    "AST lint + spec lint + engine contract smoke")
    ap.add_argument("--root", default=".", help="repo root to lint "
                    "(default: cwd; scans <root>/src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--out", default=None,
                    help="report path (default: "
                         "$REPRO_BENCH_OUT/analysis_report_torch.json)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the engine contract smoke (fast lint-only, "
                         "no device)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current lint findings as the accepted "
                         "baseline and exit")
    ap.add_argument("--device", default="cuda",
                    help="device of the contract smoke (default: cuda)")
    args = ap.parse_args(argv)

    root = Path(args.root)
    baseline = Path(args.baseline) if args.baseline else DEFAULT_BASELINE

    if args.write_baseline:
        violations = astlint.lint_paths(root)
        astlint.save_baseline(baseline, violations)
        print(f"wrote {len(violations)} accepted finding(s) to {baseline}")
        return 0

    report = build_report(root, baseline,
                          run_contracts=not args.no_contracts,
                          device=args.device)
    out = write_report(report, args.out or _default_out())

    lint = report["lint"]
    print(f"lint: {lint['total']} finding(s) "
          f"({lint['baselined']} baselined, {len(lint['new'])} new, "
          f"{len(lint['baseline_diff']['fixed'])} fixed since baseline)")
    for v in lint["new"]:
        print(f"  NEW {v['path']}:{v['line']}: {v['rule']} [{v['scope']}] "
              f"{v['snippet']!r}\n      -> {v['message']}")
    for e in lint["baseline_diff"]["fixed"]:
        print(f"  fixed: {e['rule']} {e['path']} [{e['scope']}] "
              f"{e['snippet']!r}")
    for name, issues in report["spec_lint"]["specs"].items():
        status = "clean" if not issues else f"{len(issues)} issue(s)"
        print(f"spec lint: {name}: {status}")
        for i in issues:
            print(f"  {i['rule']} at {i['where']}: {i['message']}")
    if "contracts" in report:
        print(f"contracts on {report['contracts']['device']}:")
        for name, res in report["contracts"]["checks"].items():
            if isinstance(res, dict) and "passed" in res:
                mark = "ok" if res["passed"] else "FAIL"
                print(f"contract: {name}: {mark} ({res['detail']})")
            else:
                print(f"contract: {name}: {res}")
    print(f"report: {out}")
    print("analysis:", "OK" if report["ok"] else "FAILED")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
