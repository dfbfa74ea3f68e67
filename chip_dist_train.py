#!/usr/bin/env python3
"""Training over four cards: the port's sharded training step on a
mesh of NCCL processes, one a card.

    python3 chip_dist_train.py [--runs a,b,c] [--archs qwen3_0_6b,gemma_7b]

Run from the root of a checkout on a machine with four cards.  It
builds the flash kernels once, then runs each part as processes of its
own, one a rank (`--rank` is the script's own entry for them), and
gates the results here:

- (a) float32 compute, AdamW, 3 steps of 8 x 512 from seed 0, each mesh
  against the same steps on one card: losses within rtol 1e-5
  (`LOSS_F32`), parameters within 1e-4 (`PARAMS_F32`), as
  tests/test_torch_dist_train.py holds them on the CPU.  Qwen3-0.6B, 4
  of its 28 layers, over meshes 1x4x1, 1x1x4 and 2x2x1; Gemma-7B at
  full width, 2 of its 28 layers (one card holds no more of it in
  float32 with AdamW), over 1x2x2 and 1x1x4: head dim 256 on the local
  shards, MHA, the untied 256k head.  `--archs` picks the models;
- (b) Qwen3-0.6B whole, bf16 compute, over mesh 1x2x2 through
  `launch.train` (`train_with_recovery`, a checkpoint of the whole
  state at the end, written by rank 0) against the single-card CLI's
  run: losses within rtol 1e-3 (`LOSS_BF16`, the bf16 step bound of
  tests/test_torch_train.py), the checkpoint's leaves those of the
  single-card one;
- (c) Gemma-7B whole (28 of 28 layers; one card cannot hold it with
  AdamW), bf16 compute, remat, AdamW, 3 steps of 8 x 512 over mesh
  1x2x2 through `make_train_step`: finite losses.

Every run gates each rank's flash launches a step (2 forward a layer
with remat, 1 backward, all on the variant the compute type picks:
simt for float32, wgmma for bf16) and prints the step times,
tokens/s, each card's peak memory and the collective census
(`launch.cells.CollectiveCensus`, bytes a card by kind) of a warm step.
Any failed gate exits non-zero.  The card's name and power limit come
last.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_dist_train"
DEVICE = "cuda"
REDUCED = False
BATCH, SEQ = 8, 512
STEPS = 3
LOSS_F32 = dict(rtol=1e-5, atol=0.0)
PARAMS_F32 = dict(rtol=1e-4, atol=1e-4)
LOSS_BF16 = 1e-3
# Part (a): arch -> (layers kept, meshes held against one card).
A_CASES = {"qwen3_0_6b": (4, ((1, 4, 1), (1, 1, 4), (2, 2, 1))),
           "gemma_7b": (2, ((1, 2, 2), (1, 1, 4)))}
BC_MESH = (1, 2, 2)
RANK_TIMEOUT_S = 900
# The ranks' caching allocator grows segments in place, so that blocks
# freed at one size serve others: without it Gemma-7B's step ran out of
# memory with 14.99 GiB reserved but unallocated on an 80 GB card.
ALLOC_CONF = "expandable_segments:True"


def emit(obj) -> None:
    print(json.dumps(obj, default=float), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def now() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------

def _config(arch: str, **over):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, reduced=REDUCED), **over)


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _launches(fa_mod) -> list:
    return [dict(fa_mod.flash_attention.launches_by_variant),
            dict(fa_mod.attend_backward.launches_by_variant)]


def _step_launches(before: list, after: list) -> list:
    return [{v: a[v] - b[v] for v in a} for a, b in zip(after, before)]


def _mem_gb(torch) -> float:
    """This process's allocated device memory now, GB (0 on the CPU)."""
    return torch.cuda.memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0


def _whole(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _train(torch, cfg, mesh, dev) -> dict:
    """STEPS steps of the pipeline's batches (seed 0) through
    `make_train_step`, the model drawn from seed 0; the second step
    under the census.  Returns the losses, step seconds, per-step flash
    launches, the census, peak memory and the final parameters."""
    from repro_torch.data.pipeline import DataConfig, make_batch_rows
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch.cells import CollectiveCensus
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step, rank_rows)

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = now()
    model = build_model(cfg, device=dev, mesh=mesh,
                        generator=torch.Generator(dev).manual_seed(0))
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=20))
    step, _ = make_train_step(model, tcfg, mesh)
    params, opt = init_train_state(model, tcfg, mesh)
    _sync(torch)
    init_s = now() - t0
    out_mem = [_mem_gb(torch)]
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH)
    rows = (0, BATCH) if mesh is None else rank_rows(mesh, BATCH)
    out = {"losses": [], "step_s": [], "launches": [], "init_s": init_s,
           "allocated_gb": out_mem}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_batch_rows(data, i, *rows).items()}
        before = _launches(fa_mod)
        census = CollectiveCensus()
        _sync(torch)
        t0 = now()
        with census if i == 1 else contextlib.nullcontext():
            params, opt, met = step(params, opt, batch)
        loss = float(met["loss"])
        _sync(torch)
        out["step_s"].append(now() - t0)
        out["losses"].append(loss)
        out["launches"].append(_step_launches(before, _launches(fa_mod)))
        out_mem.append(_mem_gb(torch))
        if i == 1:
            out["census"] = census.result()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if DEVICE == "cuda" else 0
    out["params"] = [_whole(p).detach() for p in tree_leaves(params)]
    return out


def _launch_train(torch, mesh_shape, port, rank, world, ckpt: Path) -> dict:
    """(b): `launch.train.run` (one card, or a mesh with explicit flags),
    STEPS steps, a checkpoint at the end; every step's flash launches
    read at the next step's start (the fault hook) and at the end."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch import train as train_mod

    argv = ["--arch", "qwen3_0_6b", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--ckpt-every", str(STEPS),
            "--ckpt-dir", str(ckpt), "--device", DEVICE, "--seed", "0"]
    if REDUCED:
        argv.append("--reduced")
    if mesh_shape is not None:
        argv += ["--mesh", "x".join(map(str, mesh_shape)), "--dist-init",
                 f"tcp://localhost:{port}", "--world-size", str(world),
                 "--rank", str(rank)]
    marks = []

    def hook(step):
        _sync(torch)
        marks.append((now(), _launches(fa_mod)))

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    args = train_mod.parse_args(argv)
    t0 = now()
    try:
        _, report = train_mod.run(args, fault_hook=hook, log=lambda m: None)
    finally:
        if mesh_shape is not None:
            from repro_torch.launch.mesh import close_train_mesh
            close_train_mesh()
    _sync(torch)
    marks.append((now(), _launches(fa_mod)))
    return {"losses": report.losses, "restarts": report.restarts,
            "seconds": now() - t0,
            "launches": [_step_launches(a[1], b[1])
                         for a, b in zip(marks, marks[1:])],
            "step_s": [b[0] - a[0] for a, b in zip(marks, marks[1:])],
            "peak_bytes": torch.cuda.max_memory_allocated()
            if DEVICE == "cuda" else 0}


def rank_main(run: str, rank: int, world: int, port: int) -> None:
    """One rank of `run`; rank 0 (and the single-card runs) write the
    result to OUT/<run>.pt, every rank its own summary to
    OUT/<run>.rank<r>.json."""
    import torch

    from repro_torch.launch.mesh import close_train_mesh, init_train_mesh

    part, mesh_name = run[0], run.rsplit("_", 1)[1]
    shape = None if mesh_name == "single" else \
        tuple(int(n) for n in mesh_name.split("x"))
    if part == "b":
        res = _launch_train(torch, shape, port, rank, world,
                            OUT / f"ckpt_{run}")
    else:
        mesh = None
        if shape is not None:
            mesh = init_train_mesh(shape, device=DEVICE,
                                   init_method=f"tcp://localhost:{port}",
                                   world_size=world, rank=rank)
        dev = torch.device(DEVICE, torch.cuda.current_device()) \
            if DEVICE == "cuda" else torch.device("cpu")
        if part == "a":
            arch = run[2:].rsplit("_", 1)[0]
            cfg = _config(arch, compute_dtype="float32",
                          n_layers=A_CASES[arch][0])
        else:
            cfg = _config("gemma_7b")
        try:
            res = _train(torch, cfg, mesh, dev)
        finally:
            if mesh is not None:
                close_train_mesh()
        res["layers"] = cfg.n_layers
    params = res.pop("params", None)
    (OUT / f"{run}.rank{rank}.json").write_text(json.dumps(res))
    if rank == 0 and params is not None:
        torch.save([p.cpu() for p in params], OUT / f"{run}.pt")


# ---------------------------------------------------------------------------
# The driver: one process a rank, gates here
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def wait_all(procs: list, timeout_s: float) -> list:
    """The exit codes of `procs` once all have ended.  As soon as one
    fails the others are killed (they would wait in a collective for a
    rank that is gone), and all are killed at `timeout_s`."""
    t_end = now() + timeout_s
    while True:
        rcs = [p.poll() for p in procs]
        if all(rc is not None for rc in rcs):
            return rcs
        if any(rc not in (None, 0) for rc in rcs) or now() > t_end:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        time.sleep(0.5)


def spawn(run: str, world: int) -> list[dict]:
    """Run `run` as `world` processes; every rank's summary."""
    port = _free_port()
    t0 = now()
    procs = []
    for r in range(world):
        log = open(OUT / f"{run}.rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-of", run,
             "--rank", str(r), "--world", str(world), "--port", str(port)],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     PYTORCH_CUDA_ALLOC_CONF=ALLOC_CONF)), log))
    try:
        rcs = wait_all([p for p, _ in procs], RANK_TIMEOUT_S)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    failed = sorted((rc < 0, r) for r, rc in enumerate(rcs) if rc)
    if failed:      # a rank that failed by itself first, not a killed one
        r = failed[0][1]
        print((OUT / f"{run}.rank{r}.log").read_text()[-4000:],
              file=sys.stderr, flush=True)
        check(False, f"{run}: ranks exited {rcs}")
    emit({"phase": "spawned", "run": run, "world": world,
          "seconds": now() - t0})
    return [json.loads((OUT / f"{run}.rank{r}.json").read_text())
            for r in range(world)]


def _check_launches(run: str, ranks: list[dict], layers: int,
                    variant: str = "wgmma") -> None:
    """Every rank's every step: 2 forward launches a layer (remat) and
    1 backward, all on `variant` (the flash kernels' pick for the
    compute type: "simt" for float32, "wgmma" for bfloat16)."""
    want = [{v: n * (v == variant) for v in ("wgmma", "simt")}
            for n in (2 * layers, layers)]
    for r, res in enumerate(ranks):
        check(all(step == want for step in res["launches"]),
              f"{run}: rank {r} flash launches a step {res['launches']}, "
              f"expected {want}")


def _summary(run: str, ranks: list[dict], layers: int) -> dict:
    r0 = ranks[0]
    warm = r0["step_s"][1:] or r0["step_s"]
    step_s = statistics.median(warm)
    return {"phase": run, "layers": layers, "losses": r0["losses"],
            "step_s": r0["step_s"], "step_ms_median_warm": step_s * 1e3,
            "tokens_per_s": BATCH * SEQ / step_s,
            "peak_gb_per_card": [r["peak_bytes"] / 1e9 for r in ranks],
            "census_rank0": r0.get("census"),
            "census_total_gb_per_card":
                [r["census"]["total"] / 1e9 for r in ranks if "census" in r],
            "init_s": r0.get("init_s")}


def part_a(archs: list[str]) -> None:
    for arch in archs:
        _part_a_arch(arch)


def _part_a_arch(arch: str) -> None:
    import numpy as np
    import torch

    base = f"a_{arch}"
    single = spawn(f"{base}_single", 1)
    layers = single[0]["layers"]
    _check_launches(f"{base}_single", single, layers, "simt")
    emit(_summary(f"{base}_single", single, layers))
    want = torch.load(OUT / f"{base}_single.pt")
    for shape in A_CASES[arch][1]:
        run = f"{base}_" + "x".join(map(str, shape))
        ranks = spawn(run, math.prod(shape))
        _check_launches(run, ranks, layers, "simt")
        got = torch.load(OUT / f"{run}.pt")
        np.testing.assert_allclose(ranks[0]["losses"], single[0]["losses"],
                                   **LOSS_F32)
        worst = 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **PARAMS_F32)
            worst = max(worst, (g - w).abs().max().item())
        check(all(r["census"]["total"] > 0 for r in ranks),
              f"{run}: a rank's census counted no collective")
        line = _summary(run, ranks, layers)
        line.update(losses_single=single[0]["losses"],
                    max_abs_param_diff=worst,
                    max_rel_loss_diff=max(
                        abs(a - b) / abs(b) for a, b in
                        zip(ranks[0]["losses"], single[0]["losses"])))
        emit(line)
        (OUT / f"{run}.pt").unlink()
    (OUT / f"{base}_single.pt").unlink()


def part_b() -> None:
    import shutil

    single = spawn("b_single", 1)
    ranks = spawn("b_" + "x".join(map(str, BC_MESH)), math.prod(BC_MESH))
    layers = _config("qwen3_0_6b").n_layers
    for run, res in (("b_single", single), ("b_mesh", ranks)):
        _check_launches(run, [{"launches": r["launches"]} for r in res],
                        layers)
    rel = [abs(a - b) / abs(b) for a, b in
           zip(ranks[0]["losses"], single[0]["losses"])]
    check(len(rel) == STEPS and max(rel) <= LOSS_BF16,
          f"b: mesh losses {ranks[0]['losses']} against one card's "
          f"{single[0]['losses']} (rel {rel})")
    metas = [json.loads(next((OUT / d).glob("step_*/meta.json"))
                        .read_text())
             for d in ("ckpt_b_single",
                       "ckpt_b_" + "x".join(map(str, BC_MESH)))]
    check(metas[0]["keys"] == metas[1]["keys"]
          and metas[0]["dtypes"] == metas[1]["dtypes"],
          "b: the mesh's checkpoint holds other leaves than one card's")
    emit({"phase": "b_launch_train_1x2x2", "losses": ranks[0]["losses"],
          "losses_single": single[0]["losses"], "max_rel_loss_diff":
              max(rel), "step_s": ranks[0]["step_s"],
          "step_s_single": single[0]["step_s"],
          "seconds": ranks[0]["seconds"],
          "seconds_single": single[0]["seconds"],
          "peak_gb_per_card": [r["peak_bytes"] / 1e9 for r in ranks],
          "peak_gb_single": single[0]["peak_bytes"] / 1e9,
          "ckpt_leaves": len(metas[1]["keys"])})
    for d in ("ckpt_b_single", "ckpt_b_" + "x".join(map(str, BC_MESH))):
        shutil.rmtree(OUT / d, ignore_errors=True)


def part_c() -> None:
    run = "c_" + "x".join(map(str, BC_MESH))
    ranks = spawn(run, math.prod(BC_MESH))
    layers = ranks[0]["layers"]
    _check_launches(run, ranks, layers)
    for r in ranks:
        check(all(x == x and abs(x) < float("inf") for x in r["losses"]),
              f"c: non-finite losses {r['losses']}")
        check(r["census"]["total"] > 0, "c: a rank counted no collective")
    emit(_summary(run, ranks, layers))


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="a,b,c")
    ap.add_argument("--archs", default=",".join(A_CASES),
                    help="part (a)'s models, of " + ", ".join(A_CASES))
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if args.rank_of:
        rank_main(args.rank_of, args.rank, args.world, args.port)
        return 0

    import torch
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("chip_dist_train: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    n_cards = torch.cuda.device_count() if DEVICE == "cuda" else 4
    if n_cards < 4:
        print(f"chip_dist_train: needs 4 cards, {n_cards} visible",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t0 = now()
    OUT.mkdir(parents=True, exist_ok=True)
    if DEVICE == "cuda":
        for name in ("flash_attention", "flash_attention_bwd"):
            build.build(name)
    emit({"phase": "build", "seconds": now() - t0, "cards": n_cards,
          "torch": torch.__version__})
    archs = args.archs.split(",")
    check(set(archs) <= set(A_CASES), f"--archs: {archs}, of {list(A_CASES)}")
    parts = {"a": lambda: part_a(archs), "b": part_b, "c": part_c}
    for name in args.runs.split(","):
        t1 = now()
        parts[name]()
        emit({"phase": f"part_{name}", "seconds": now() - t1})
    emit({"phase": "total", "seconds": now() - t0})
    if DEVICE == "cuda":
        print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
