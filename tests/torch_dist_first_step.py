#!/usr/bin/env python3
"""Seconds of a reduced Qwen3's first training step (DTensor plans
every new operation), its second step and a prefill over a gloo world
on the CPU, a process a rank: the worker's `stream` job
(`tests/_torch_dist_worker.py`) on the package under `--src`.

    python3 tests/torch_dist_first_step.py [--src DIR] [--mesh 1x2x2]
        [--seq 32]

Run it on the `src/` of two trees (an older one unpacked by `git
archive`) to compare their planning cost; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

WORKER = Path(__file__).with_name("_torch_dist_worker.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(WORKER.parents[1] / "src"))
    ap.add_argument("--mesh", default="1x2x2")
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args()
    shape = [int(n) for n in args.mesh.split("x")]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(args.src).resolve()))
    with tempfile.TemporaryDirectory() as d:
        spec = Path(d) / "spec.json"
        spec.write_text(json.dumps({
            "shape": shape, "world_size": math.prod(shape),
            "init_method": f"tcp://localhost:{port}", "out": d,
            "params": "", "batch": "",
            "jobs": [{"name": "stream", "kind": "stream",
                      "seq": args.seq}]}))
        procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec),
                                   str(r)], env=env)
                 for r in range(math.prod(shape))]
        rcs = [p.wait(timeout=600) for p in procs]
        if any(rcs):
            print(f"ranks exited {rcs}", file=sys.stderr)
            return 1
        res = torch.load(Path(d) / "stream.pt", weights_only=False)
    print(json.dumps({"src": args.src, "mesh": args.mesh, "seq": args.seq,
                      **{k: res[k] for k in ("first_step_s", "second_step_s",
                                             "prefill_s", "loss")},
                      "stream": res["train"][0][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
