"""Hillclimbing driver: count a dry-run cell under a named variant
(hypothesis), derive the three roofline terms on the H100, and record
(variant -> counts -> terms) in artifacts/perf/<arch>_<shape>.json.
The port of `repro.launch.hillclimb`, on the meta device (no GPU).

    python -m repro_torch.launch.hillclimb --arch kimi_k2_1t \\
        --shape train_4k --variant no_remat

The collective term is the cell's census (`cells.run_cell`, bytes a
device over a fake production mesh of `--device`'s type: ``cuda``, the
default, NCCL's plans; ``cpu`` gloo's) over the H100's link bandwidth,
so the variants that act on collectives (`compress_grads`, `dp_only`,
the microbatches) move it.  Prefill and decode cells take their
census the same way (one prefill or decode step over the fake mesh).
"""
from __future__ import annotations

import argparse
import json
import pathlib

VARIANTS: dict[str, dict] = {
    "baseline": {},
    # full remat recomputes the forward inside the backward: compute
    # term should drop by the recompute share (~fwd/3fwd = 25-33%)
    "no_remat": {"cfg": {"remat": False}},
    # MoE capacity 1.25 -> 1.0: expert GEMM + dispatch traffic scale
    # with capacity; predicts ~20% off the expert share of compute
    "cap_1.0": {"cfg": {"capacity_factor": 1.0}},
    # 2 microbatches: same math, ~half the live activation footprint,
    # but FSDP weight all-gathers run twice -> collective term up
    "microbatch_2": {"train": {"microbatches": 2}},
    "microbatch_4": {"train": {"microbatches": 4}},
    # int8 gradient round-trip ahead of the (DCN) pod reduction
    "compress_grads": {"train": {"compress_grads": True}},
    # bf16 optimizer moments (memory-bound cells)
    "bf16_moments": {"train_opt_moment": "bfloat16"},
    # pure data parallelism: for small-d models, 16-way TP makes the
    # per-layer activation collectives (the stream's TP gathers and
    # reduce-scatters + KV gather) dominate; replicating the model over
    # "model" and folding it into the batch axes removes them entirely
    # at the cost of replicated weights (fine below ~2B params) and
    # per-step gradient all-reduce
    "dp_only": {"parallelism": "dp"},
    # combined beyond-paper configs
    "dp_mb4": {"parallelism": "dp", "train": {"microbatches": 4}},
    "mb4_cap1": {"cfg": {"capacity_factor": 1.0},
                 "train": {"microbatches": 4}},
}


def run(arch: str, shape: str, variant: str, multi_pod: bool = False,
        device: str = "cuda"):
    from ..core.arch import H100_SXM
    from ..core.tpu_model import step_roofline
    from .cells import run_cell

    spec = VARIANTS[variant]
    train_over = dict(spec.get("train", {}))
    if "train_opt_moment" in spec:
        from ..train.optimizer import OptConfig
        train_over["opt"] = OptConfig(
            moment_dtype=spec["train_opt_moment"])
    res = run_cell(arch, shape, multi_pod,
                   cfg_overrides=spec.get("cfg"),
                   train_overrides=train_over or None,
                   parallelism=spec.get("parallelism", "tp"),
                   device=device)
    if not res.ok:
        raise SystemExit(f"variant failed: {res.error or res.skip_reason}")
    terms = step_roofline(res.flops, res.bytes_accessed,
                          res.collectives["total"], target=H100_SXM)
    rec = {
        "variant": variant,
        "flops": res.flops,
        "bytes": res.bytes_accessed,
        "coll": res.collectives,
        "memory": res.memory,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "bound": terms.bound,
        "step_s": terms.step_s,
    }
    out = pathlib.Path("artifacts/perf")
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{arch}_{shape}.json"
    data = json.loads(path.read_text()) if path.exists() else {}
    data[variant] = rec
    path.write_text(json.dumps(data, indent=1, default=float))
    print(f"[perf] {arch} {shape} {variant}: "
          f"comp={terms.compute_s*1e3:.2f}ms "
          f"mem={terms.memory_s*1e3:.2f}ms "
          f"coll={terms.collective_s*1e3:.2f}ms "
          f"bound={terms.bound} step={terms.step_s*1e3:.2f}ms (H100 SXM)")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake mesh's device type for the census")
    args = ap.parse_args()
    run(args.arch, args.shape, args.variant, args.multi_pod, args.device)


if __name__ == "__main__":
    main()
