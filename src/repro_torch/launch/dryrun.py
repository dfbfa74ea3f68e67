"""Dry-run driver: counts every (architecture x input-shape) cell on
the production meshes, 16x16 single-pod and 2x16x16 multi-pod, on the
meta device, and records per-device FLOPs, bytes, memory and the
collective census of one train, prefill or decode step.  The port of `repro.launch.dryrun`,
with the same CLI and the same files; it uses no GPU (nothing is
allocated or launched) and sets no compiler flags.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k \\
      [--multi-pod] [--out artifacts/dryrun] [--device cuda|cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
      [--subprocess] [--device cuda|cpu]

`--device` is the fake production mesh's device type for the census
(`launch.cells.run_cell`): ``cuda`` (the default) plans NCCL's
collectives and needs a torch built with CUDA, not a card; ``cpu``
plans gloo's, which do an all-to-all as an all-gather.  `--subprocess`
isolates each cell in its own process; results are merged into
<out>/dryrun_<mesh>.json either way.  Exit code 0 when every cell is
counted or skipped by the reference's rules, 1 when a single cell
fails, and the failures' list otherwise.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def _merge(out_dir: pathlib.Path, mesh_name: str, record: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"dryrun_{mesh_name}.json"
    data = {}
    if path.exists():
        data = json.loads(path.read_text())
    data[f"{record['arch']}|{record['shape']}"] = record
    path.write_text(json.dumps(data, indent=1, default=float))
    return path


def run_one(arch: str, shape: str, multi_pod: bool, out_dir: pathlib.Path,
            device: str = "cuda"):
    from .cells import run_cell
    res = run_cell(arch, shape, multi_pod, device=device)
    rec = res.to_json()
    mesh_name = rec["mesh"]
    _merge(out_dir, mesh_name, rec)
    status = ("OK" if res.ok else
              ("SKIP: " + res.skip_reason if res.skip_reason else
               "FAIL: " + res.error[:200]))
    print(f"[dryrun] {arch:22s} {shape:12s} {mesh_name:8s} {status}")
    if res.ok:
        print(f"         flops/dev={res.flops:.3e} "
              f"bytes/dev={res.bytes_accessed:.3e} "
              f"args/dev={res.memory['argument_size_in_bytes']:.3e}B "
              f"coll/dev={res.collectives['total']:.3e}B "
              f"(trace {res.lower_s:.1f}s census {res.compile_s:.1f}s)")
    return res.ok or bool(res.skip_reason)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--subprocess", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake mesh's device type for the census")
    args = ap.parse_args()
    out_dir = pathlib.Path(args.out)

    if args.all:
        from ..configs import ARCH_IDS
        from ..configs.base import SHAPES
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in meshes:
                    if args.subprocess:
                        cmd = [sys.executable, "-m",
                               "repro_torch.launch.dryrun", "--arch", arch,
                               "--shape", shape, "--out", str(out_dir),
                               "--device", args.device]
                        if mp:
                            cmd.append("--multi-pod")
                        r = subprocess.run(cmd)
                        if r.returncode != 0:
                            failures.append((arch, shape, mp))
                    else:
                        from .cells import CELL_ERRORS
                        try:
                            ok = run_one(arch, shape, mp, out_dir,
                                         args.device)
                            if not ok:
                                failures.append((arch, shape, mp))
                        # a cell whose trace raises (a shape or type
                        # error in the model) is recorded so the sweep
                        # continues; the driver exits non-zero at the end.
                        except CELL_ERRORS as e:
                            print(f"[dryrun] {arch} {shape} EXC: {e!r}")
                            failures.append((arch, shape, mp))
        if failures:
            sys.exit(f"dry-run failures: {failures}")
        print("[dryrun] all cells passed")
        return

    ok = run_one(args.arch, args.shape, args.multi_pod, out_dir, args.device)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
