#!/usr/bin/env python3
"""Population sharding on the card, without the kernel build.

    python3 chip_pop_shards.py [--steps S --round-every R]

Runs `chip_smoke.phase_pop_shards` twice (the second pass warm): the
ResNet-50 device-seeded fused search at P = 256 at 1, 2 and 4 shards
over repeated cuda:0, and over every visible card when there are
several; one chunk's rounded read-back
and reduced best against one shard's; the tiny fleet (TPU v5e + edge)
at 2 shards, over cuda:0 + cuda:1 too where there are two cards; one
service request degraded by a `ShardLossFault`.  Every gate is the
phase's own.  `--steps` and `--round-every` replace chip_smoke's
`POP_SHARDS` cut (50 steps rounded once) for the search.  Each pass
prints the phase's JSON line and its seconds; then the card's name and
power limit.  Run it with as many cards as the mesh should span.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int)
    ap.add_argument("--round-every", type=int)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_pop_shards: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import archspec, fleet, mapping, problem, search
    from repro_torch.runtime import faults
    from repro_torch.serve import cosearch_service as service_mod
    from repro_torch.workloads import dnn_zoo

    cfg_kw = None       # chip_smoke's own cut
    if args.steps is not None or args.round_every is not None:
        cfg_kw = dict(cs.POP_SHARDS)
        if args.steps is not None:
            cfg_kw["steps"] = args.steps
        if args.round_every is not None:
            cfg_kw["round_every"] = args.round_every
    wl = dnn_zoo.resnet50()
    for rep in range(2):
        t0 = cs.now()
        cs.phase_pop_shards(torch, search, fleet, mapping, archspec, api,
                            service_mod, faults, problem, wl,
                            cfg_kw=cfg_kw)
        print(f"rep {rep}: pop_shards took {cs.now() - t0:.3f} s on "
              f"{torch.cuda.device_count()} card(s)", flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
