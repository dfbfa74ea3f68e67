#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
the sources in the checkout, holds each against its plain PyTorch
version on the card, drives the port's two paths through the entry
points a user calls — the DOSA-tuned matmul at Qwen3-0.6B's FFN
up-projection width and the DOSA co-search at the paper's protocol on
ResNet-50 — then checks the card against the CPU on a small search.
Each phase prints one JSON line; any failure raises and exits non-zero.
The second-to-last lines are the kernel summary and the card's name and
power limit (from nvidia-smi); the last line is
``{"ok": true, "device": {...}}``.

It imports torch and the port only, never jax or the JAX reference.
All timing lives here (the package reads no clock).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

MM_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 1024, 256),
             (512, 64, 128), (1000, 777, 333)]       # (m, k, n); last ragged
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# Qwen3-0.6B FFN up-projection (d_model=1024, d_ff=3072) at 4096 tokens.
FFN_M, FFN_K, FFN_N = 4096, 1024, 3072


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def now() -> float:
    return time.perf_counter()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of `fn()` over warm runs, each timed with a
    pair of CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_kernel_vs_plain(torch, matmul, matmul_ref):
    """Every shape of the kernel tests plus a ragged one, f32 and bf16,
    on the card against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for (m, k, n) in MM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            y = torch.randn((k, n), generator=gen, device="cuda").to(dt)
            out = matmul(x, y, bm=m, bk=k, bn=n)
            ref = matmul_ref(x, y)
            torch.cuda.synchronize()
            tol = TOL[str(dt).split(".")[-1]]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            key = str(dt).split(".")[-1]
            err = (out.float() - ref.float()).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "kernel_vs_plain", "shapes": MM_SHAPES,
          "max_abs_err": worst, "tolerance": TOL})


def phase_tuned_matmul(torch, tuned_matmul, tuned_blocks, matmul_ref):
    """The tuned path at full width: tune on the card, then the kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((FFN_M, FFN_K), generator=gen,
                    device="cuda").to(torch.bfloat16)
    y = torch.randn((FFN_K, FFN_N), generator=gen,
                    device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = now()
    out = tuned_matmul(x, y)
    torch.cuda.synchronize()
    secs = now() - t0
    blocks = tuned_blocks(FFN_M, FFN_K, FFN_N, device="cuda")
    ref = matmul_ref(x, y)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    check(out.shape == (FFN_M, FFN_N) and out.dtype == torch.bfloat16,
          "tuned_matmul output shape/dtype")
    emit({"phase": "tuned_matmul", "shape": [FFN_M, FFN_K, FFN_N],
          "dtype": "bfloat16", "blocks_bm_bk_bn": list(blocks),
          "seconds_incl_tuning": secs})
    return x, y


def phase_cosearch(torch, search, oracle, dnn_zoo):
    """The paper's protocol on ResNet-50, fused engine on the card."""
    import numpy as np

    wl = dnn_zoo.resnet50()
    cfg = search.SearchConfig(steps=1490, round_every=500,
                              n_start_points=7, seed=0)
    torch.cuda.synchronize()
    t0 = now()
    res = search.dosa_search(wl, cfg, population=7, device="cuda")
    secs = now() - t0
    edp, _ = oracle.evaluate_workload(res.best_mappings, wl.layers)
    check(edp == res.best_edp, f"oracle re-evaluation {edp} != best_edp "
          f"{res.best_edp}")
    check(np.isfinite(res.best_edp) and res.best_edp <= min(res.start_edps),
          "best EDP is finite and no worse than the start points")
    check(len(res.best_mappings) == len(wl.layers), "best mappings")
    emit({"phase": "cosearch_resnet50", "layers": len(wl.layers),
          "steps": cfg.steps, "round_every": cfg.round_every,
          "n_start_points": cfg.n_start_points, "population": 7,
          "best_edp": res.best_edp, "n_evals": res.n_evals,
          "oracle_edp": edp, "seconds": secs})
    return wl, cfg, res


def chunk_inputs(search, wl, cfg):
    """The fused engine of (wl, cfg) on the card and the inputs of its
    one population chunk, built the way the fused driver builds them."""
    from repro_torch.core.model import population_best_init

    engine = search.make_fused_runner(wl, cfg, "cuda")
    rec = search._Recorder(wl, cfg, engine.cspec)
    starts = search._start_points(wl, cfg, rec)
    theta, orders = search._population_inputs(starts, engine.cspec, "cuda")
    return engine, theta, orders, population_best_init(theta, orders)


def phase_chunk_sync_free(torch, search, oracle, wl, cfg, res):
    """One fused chunk again, segment by segment, under
    set_sync_debug_mode("error") (any host sync raises), with each
    segment timed by CUDA events.  Its rounded candidates, replayed
    through the oracle, must give the main run's best EDP: the search
    is deterministic for a seed."""
    from repro_torch.core.mapping import unstack_mappings

    engine, theta, orders, best = chunk_inputs(search, wl, cfg)
    seg_lens = search._segment_lengths(cfg.steps, cfg.round_every)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(seg_lens) + 1)]
    outs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        events[0].record()
        for i, n_steps in enumerate(seg_lens):
            theta, orders, best, out = engine.segment(theta, orders, best,
                                                      n_steps)
            outs.append(out[:2])
            events[i + 1].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seg_ms = [events[i].elapsed_time(events[i + 1])
              for i in range(len(seg_lens))]
    check(bool(torch.isfinite(best.edp).all()), "chunk best EDP finite")
    replay = min(res.start_edps)
    for f_round, o_round in outs:
        f_np = f_round.cpu().numpy().astype(float)
        o_np = o_round.cpu().numpy()
        for p in range(f_np.shape[0]):
            edp, _ = oracle.evaluate_workload(
                unstack_mappings(f_np[p], o_np[p]), wl.layers)
            replay = min(replay, edp)
    check(replay == res.best_edp, f"rerun of the chunk gives best EDP "
          f"{replay}, the main run {res.best_edp}: not deterministic")
    emit({"phase": "chunk_sync_free", "sync_debug_mode": "error",
          "segment_steps": seg_lens, "segment_ms": seg_ms,
          "ms_per_gd_step": [t / s for t, s in zip(seg_ms, seg_lens)],
          "rerun_best_edp": replay, "deterministic": True})


def phase_profile_gd(torch, search, wl, cfg, n_steps: int = 10):
    """Where a GD step's time goes: `n_steps` Adam steps of the fused
    engine timed on the host clock, then the same under torch.profiler
    — device operations per step, device busy time per step, and the
    busy share of an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    engine, theta, orders, _ = chunk_inputs(search, wl, cfg)
    search._adam_segment(engine.grad_fn, cfg.lr, theta, orders, 2)  # warm
    torch.cuda.synchronize()
    t0 = now()
    search._adam_segment(engine.grad_fn, cfg.lr, theta, orders, n_steps)
    torch.cuda.synchronize()
    step_ms = (now() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        search._adam_segment(engine.grad_fn, cfg.lr, theta, orders, n_steps)
        torch.cuda.synchronize()
        prof_ms = (now() - t0) * 1e3 / n_steps
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_steps
    emit({"phase": "profile_gd_steps", "steps": n_steps,
          "wall_ms_per_step": step_ms,
          "wall_ms_per_step_profiled": prof_ms,
          "device_ops_per_step": len(dev) / n_steps,
          "device_busy_ms_per_step": busy_ms if dev else "not measured",
          "device_busy_share": busy_ms / step_ms if dev
          else "not measured"})


def phase_card_vs_cpu(search, problem):
    """The end-to-end test's short config on the card and on the CPU:
    rounded candidates and results must be equal."""
    import numpy as np

    Layer, Workload = problem.Layer, problem.Workload
    wl = Workload(layers=(
        Layer.conv(64, 64, 3, 56, name="c1"),
        Layer.matmul(512, 1024, 768, name="m1"),
        Layer.conv(128, 256, 3, 28, stride=2, name="c2"),
    ), name="tiny")
    cfg = search.SearchConfig(steps=20, round_every=10, n_start_points=3,
                              seed=0)
    out = {}
    for pop in (None, 2):
        r = {dev: search.dosa_search(wl, cfg, population=pop, device=dev)
             for dev in ("cuda", "cpu")}
        a, b = r["cuda"], r["cpu"]
        check(a.best_edp == b.best_edp, f"best_edp cuda {a.best_edp} "
              f"!= cpu {b.best_edp} (population={pop})")
        check(a.history == b.history and a.n_evals == b.n_evals
              and a.start_edps == b.start_edps,
              f"history/n_evals differ (population={pop})")
        for ma, mb in zip(a.best_mappings, b.best_mappings):
            check(np.array_equal(ma.f, mb.f)
                  and np.array_equal(ma.order, mb.order),
                  f"best mappings differ (population={pop})")
        out["sequential" if pop is None else "fused"] = {
            "best_edp": a.best_edp, "n_evals": a.n_evals}
    emit({"phase": "card_vs_cpu", "equal": True, **out})


def phase_matmul_timing(torch, matmul, matmul_ref, x, y, launches):
    """Kernel, plain version and torch.matmul at the main shape."""
    m, k = x.shape
    n = y.shape[1]
    blocks = dict(bm=m, bk=k, bn=n)
    kern = matmul(x, y, **blocks)
    ref = matmul_ref(x, y)
    err = (kern.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: matmul(x, y, **blocks))
    plain_ms = cuda_ms(lambda: matmul_ref(x, y))
    library_ms = cuda_ms(lambda: torch.matmul(x, y))
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n + m * n) * x.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"name": "matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/matmul.cu",
           "replaces": "src/repro/kernels/matmul/matmul.py:24",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms, "held_against_plain": True}
    emit({"phase": "matmul_timing", "shape": [m, k, n], "dtype": str(x.dtype),
          "flops": flops, "bytes": nbytes,
          "tflops": flops / (ms * 1e-3) / 1e12,
          "f32_fma_share": flops / (ms * 1e-3) / PEAK_F32_FLOPS, **row})
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import oracle, problem, search
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul.matmul import matmul
    from repro_torch.kernels.matmul.ops import tuned_blocks, tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.workloads import dnn_zoo

    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = now()
    lib_path = build.build("matmul")
    emit({"phase": "build", "library": lib_path.name,
          "seconds": now() - t0,
          "ptxas": lib_path.with_suffix(".log").read_text()})

    phase_kernel_vs_plain(torch, matmul, matmul_ref)

    # ---- the main path: counts from 0, both paths, counts read after.
    matmul.launches = 0
    x, y = phase_tuned_matmul(torch, tuned_matmul, tuned_blocks, matmul_ref)
    wl, cfg, res = phase_cosearch(torch, search, oracle, dnn_zoo)
    launches = matmul.launches
    check(launches > 0, "the tuned path never launched the matmul kernel")
    emit({"phase": "main_path_launches", "matmul": launches})

    phase_chunk_sync_free(torch, search, oracle, wl, cfg, res)
    phase_profile_gd(torch, search, wl, cfg)
    phase_card_vs_cpu(search, problem)
    row = phase_matmul_timing(torch, matmul, matmul_ref, x, y, launches)

    emit({"kernels": [row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
