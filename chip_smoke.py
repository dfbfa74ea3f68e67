#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels
(the matmul and the flash attention, one nvcc each, in parallel) from
the sources in the checkout and prints the compiler's register, spill
and shared-memory report.  Each kernel has two variants: "wgmma"
(tensor cores and TMA, for bfloat16) and "simt" (IEEE float32 FMA, for
float32 and for bfloat16 matmul shapes TMA cannot take).  It holds each
against its plain PyTorch version on the card, checking from the
per-variant launch counts which variant each case ran, and drives the
port's three paths through the entry points a user calls, each with
the launch counts set to 0 just before it and read just after:

- the DOSA-tuned matmul at Qwen3-0.6B's FFN up-projection width, then
  the DOSA co-search at the paper's protocol on ResNet-50;
- `LM.prefill` of Qwen3-0.6B at full width (4 prompts x 4096 tokens),
  whose attention runs in the flash kernel, 28 launches a call;
- the serve loop (`launch.serve`) at full width: 4 requests, prompt
  128, 32 generated tokens, greedy.

Then it profiles a prefill call, decode steps and GD steps, checks the
card against the CPU (a small search; the reduced LM) and
teacher-forced decode against prefill at full width.  The paper's
Sec. 6 experiments come next, with the counts again set to 0:

- `calibration_train`: the Fig. 10 training set (AlexNet, ResNeXt-50,
  VGG-16, DeepBench; 31 random mappings a layer) labelled by the RTL
  stand-in, the residual and direct latency models trained on the card
  (600 epochs each), their held-out Spearman beside the analytical
  model's, and 20 epochs on the card against the CPU;
- `calibrated_search_unet`: the Fig. 12 protocol on UNet (16x16 array
  frozen) with the analytical, DNN-only and combined latency models,
  judged by the RTL stand-in against the default Gemmini; the combined
  search's fused and host-batched engines held equal on a short config;
- `surrogate_chunk_sync_free` and `profile_gd_surrogate`: one chunk of
  that short combined search free of host syncs, and its GD steps
  profiled beside ResNet-50's analytical ones;
- `baselines_resnet50`: random search (host numpy) with about the
  ResNet-50 co-search's sample count.

Last, it times both kernels (the wgmma variants of the main path, and
the float32 flash on its simt kernel) beside their bounds, plain
versions and library calls.
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

# (m, k, n): the kernel tests' shapes, one ragged in M, K and N that
# TMA can take (16-byte rows), one it cannot.
MM_SHAPES = [(128, 128, 128), (256, 512, 384), (64, 1024, 256),
             (512, 64, 128), (1000, 776, 336), (1000, 777, 333)]
# The bfloat16 shape whose K and N are not multiples of 8 (no TMA): simt.
MM_SIMT_BF16 = (1000, 777, 333)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# Qwen3-0.6B FFN up-projection (d_model=1024, d_ff=3072) at 4096 tokens.
FFN_M, FFN_K, FFN_N = 4096, 1024, 3072

# Flash attention against its plain version: (b, hq, hkv, sq, sk, d,
# causal, q_offset).  tests/test_kernels.py's sweep (bh 3, d 64), then
# Qwen3-0.6B's heads (16 over 8, d 128), a ragged S=1000, 100 queries
# after a 900-token prefix, the reduced config's d 32, GQA at d 64 with
# a ragged causal S=300, and 130 queries after a 4003-token prefix
# (Sk = 4133 not a multiple of the 128-key tile).
FLASH_CASES = [
    (1, 3, 3, 128, 128, 64, True, 0), (1, 3, 3, 128, 128, 64, False, 0),
    (1, 3, 3, 256, 128, 64, False, 0), (1, 3, 3, 128, 256, 64, False, 0),
    (2, 16, 8, 512, 512, 128, True, 0),
    (1, 16, 8, 1000, 1000, 128, True, 0),
    (1, 16, 8, 1000, 1000, 128, False, 0),
    (2, 16, 8, 100, 1000, 128, True, 900),
    (2, 4, 2, 77, 333, 32, True, 256),
    (1, 4, 2, 300, 300, 64, True, 0),
    (1, 16, 8, 130, 4133, 128, True, 4003),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# Qwen3-0.6B prefill: 4 prompts x 4096 tokens.
PREFILL_B, PREFILL_S = 4, 4096
# Teacher-forced decode against prefill at full width, float32 compute:
# logits and K/V stacks within this (rtol and atol).
DECODE_TOL_F32 = 1e-3

# Fig. 10's training set (benchmarks/fig10_11_pred_accuracy.py): the
# training networks' 50 layers at published dims, 1567 // 50 = 31
# random mappings a layer, seed 0, every 5th sample held out; 600
# epochs a model.  Training on the card against the CPU: 20 epochs from
# the same initial weights, predictions within TRAIN_CARD_CPU_RTOL.
TRAIN_NETS = ("alexnet", "resnext50", "vgg16", "deepbench")
TRAIN_SAMPLES = 1567
TRAIN_EPOCHS = 600
TRAIN_CARD_CPU_RTOL = 1e-4
# Fig. 12's protocol (benchmarks/fig12_rtl_opt.py) on UNet, fused with
# population 3; its short form holds the fused engine to the
# host-batched one.
FIG12 = dict(steps=1490, round_every=500, n_start_points=3, seed=17)
FIG12_SHORT = dict(steps=160, round_every=80, n_start_points=3, seed=17)
# Cuts from the paper's scale above (none).
CUTS: list = []


def emit(obj) -> None:
    # default=float: the DNN-only model's predicted EDP is a numpy
    # float32, as in the reference.
    print(json.dumps(obj, default=float), flush=True)


def now() -> float:
    return time.perf_counter()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, warmup: int = 3, iters: int = 20, reps: int = 1) -> float:
    """Median milliseconds of one `fn()` over warm runs: each run is
    `reps` back-to-back calls between a pair of CUDA events, so that
    for short kernels the host's launch time overlaps the device's
    work instead of adding to it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def ran_on(counts: dict, before: dict, expected: str, what: str) -> None:
    """One launch since `before`, on the `expected` variant."""
    diff = {v: counts[v] - before[v] for v in counts}
    check(diff == {v: int(v == expected) for v in counts},
          f"{what}: launches by variant {diff}, expected one on "
          f"{expected}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_kernel_vs_plain(torch, matmul, matmul_ref):
    """Every shape of the kernel tests plus a ragged one, f32 and bf16,
    on the card against the plain version; bf16 runs on wgmma except
    MM_SIMT_BF16, f32 always on simt."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    variants = {}
    for (m, k, n) in MM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            y = torch.randn((k, n), generator=gen, device="cuda").to(dt)
            expected = ("wgmma" if dt == torch.bfloat16
                        and (m, k, n) != MM_SIMT_BF16 else "simt")
            before = dict(matmul.launches_by_variant)
            out = matmul(x, y, bm=m, bk=k, bn=n)
            ran_on(matmul.launches_by_variant, before, expected,
                   f"matmul {(m, k, n)} {dt}")
            variants[f"{m}x{k}x{n} {str(dt).split('.')[-1]}"] = expected
            ref = matmul_ref(x, y)
            torch.cuda.synchronize()
            tol = TOL[str(dt).split(".")[-1]]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            key = str(dt).split(".")[-1]
            err = (out.float() - ref.float()).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "kernel_vs_plain", "shapes": MM_SHAPES,
          "variants": variants, "max_abs_err": worst, "tolerance": TOL})


def phase_tuned_matmul(torch, tuned_matmul, tuned_blocks, matmul_ref,
                       matmul):
    """The tuned path at full width: tune on the card, then the kernel
    (the wgmma variant at this bf16 shape)."""
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
    check(matmul.launches_by_variant["wgmma"] >= 1,
          "tuned_matmul at the FFN shape did not run on wgmma")
    emit({"phase": "tuned_matmul", "shape": [FFN_M, FFN_K, FFN_N],
          "dtype": "bfloat16", "blocks_bm_bk_bn": list(blocks),
          "variant": "wgmma", "seconds_incl_tuning": secs})
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


def phase_chunk_sync_free(torch, search, wl, cfg, res,
                          phase: str = "chunk_sync_free"):
    """One fused chunk again, segment by segment, under
    set_sync_debug_mode("error") (any host sync raises), with each
    segment timed by CUDA events.  Its rounded candidates, replayed
    through the search's oracle, must give the main run's best EDP:
    the search is deterministic for a seed."""
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
            edp = search._oracle_edp(unstack_mappings(f_np[p], o_np[p]),
                                     wl, cfg, engine.cspec)
            replay = min(replay, edp)
    check(replay == res.best_edp, f"rerun of the chunk gives best EDP "
          f"{replay}, the main run {res.best_edp}: not deterministic")
    emit({"phase": phase, "sync_debug_mode": "error",
          "segment_steps": seg_lens, "segment_ms": seg_ms,
          "ms_per_gd_step": [t / s for t, s in zip(seg_ms, seg_lens)],
          "rerun_best_edp": replay, "deterministic": True})


def phase_profile_gd(torch, search, wl, cfg, n_steps: int = 10,
                     phase: str = "profile_gd_steps") -> dict:
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
    rec = {"phase": phase, "workload": wl.name, "steps": n_steps,
           "wall_ms_per_step": step_ms,
           "wall_ms_per_step_profiled": prof_ms,
           "device_ops_per_step": len(dev) / n_steps,
           "device_busy_ms_per_step": busy_ms if dev else "not measured",
           "device_busy_share": busy_ms / step_ms if dev
           else "not measured"}
    emit(rec)
    return rec


def phase_calibration_train(torch, np, surrogate, rtl_sim, dnn_zoo,
                            GEMMINI_DEFAULT):
    """Fig. 10 on the card: the training set labelled by the RTL
    stand-in (host), the residual and direct models trained on the
    card, the held-out Spearman of each beside the analytical model's;
    then 20 epochs from the same initial weights on the card and on the
    CPU, predictions within TRAIN_CARD_CPU_RTOL."""
    layers = [lay for name in TRAIN_NETS
              for lay in dnn_zoo.get_workload(name).layers]
    n_per = max(TRAIN_SAMPLES // len(layers), 4)
    t0 = now()
    feats, ana, rtl, _ = rtl_sim.build_dataset(layers, GEMMINI_DEFAULT,
                                               n_per_layer=n_per, seed=0)
    dataset_s = now() - t0
    te = np.arange(len(feats)) % 5 == 0
    tr = ~te
    n_fit = int(tr.sum()) - max(int(tr.sum() * 0.15), 1)
    adam_steps = TRAIN_EPOCHS * max(n_fit // 128, 1)
    models, runs = {}, {}
    for kind in ("residual", "direct"):
        torch.cuda.synchronize()
        t0 = now()
        if kind == "residual":
            m = surrogate.train_residual_model(
                feats[tr], ana[tr], rtl[tr], epochs=TRAIN_EPOCHS,
                device="cuda")
        else:
            m = surrogate.train_direct_model(
                feats[tr], rtl[tr], epochs=TRAIN_EPOCHS, device="cuda")
        torch.cuda.synchronize()
        secs = now() - t0
        check(m.device.type == "cuda" and np.isfinite(m.val_mse),
              f"{kind} model trained on the card")
        models[kind] = m
        runs[kind] = {"seconds": secs, "adam_steps": adam_steps,
                      "ms_per_adam_step": secs * 1e3 / adam_steps,
                      "val_mse": m.val_mse}
    sp = {"analytical": surrogate.spearman(ana[te], rtl[te])}
    for kind, m in models.items():
        sp[kind] = surrogate.spearman(m.predict_latency(feats[te], ana[te]),
                                      rtl[te])
    init = [{k: v.numpy() for k, v in p.items()}
            for p in surrogate.init_mlp(torch.Generator().manual_seed(0),
                                        n_in=feats.shape[1], device="cpu")]
    preds = {dev: surrogate.train_residual_model(
        feats[tr], ana[tr], rtl[tr], epochs=20, init_params=init,
        device=dev).predict_latency(feats[te], ana[te])
        for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(preds["cuda"], preds["cpu"],
                               rtol=TRAIN_CARD_CPU_RTOL)
    emit({"phase": "calibration_train", "nets": TRAIN_NETS,
          "layers": len(layers), "per_layer": n_per,
          "samples": int(len(feats)), "held_out": int(te.sum()),
          "dataset_host_seconds": dataset_s, "epochs": TRAIN_EPOCHS,
          "train": runs, "spearman_held_out": sp,
          "card_vs_cpu_20_epochs_max_rel_err":
              float(np.max(np.abs(preds["cuda"] / preds["cpu"] - 1))),
          "card_vs_cpu_rtol": TRAIN_CARD_CPU_RTOL, "cuts": CUTS})
    return models


def phase_calibrated_search_unet(torch, search, calibration, rtl_sim,
                                 cosa, dnn_zoo, GEMMINI_DEFAULT, models):
    """Fig. 12 and Table 7 on UNet: the 16x16 array frozen, buffers and
    mappings searched with the analytical, DNN-only (direct) and
    combined (residual) latency models, fused on the card, each judged
    by the RTL stand-in's EDP against the default Gemmini (CoSA
    mappings, 32 KB accumulator, 128 KB scratchpad).  Gates: each
    result's oracle (the predicted EDP through its model, or the
    analytical oracle) re-evaluated on its best mappings equals its
    `best_edp`; the combined search's short form gives equal results
    on the fused and host-batched engines."""
    wl = dnn_zoo.unet()
    default_maps = cosa.cosa_map_workload(list(wl.layers), GEMMINI_DEFAULT)
    edp_default = rtl_sim.rtl_workload_edp(default_maps, wl.layers,
                                           GEMMINI_DEFAULT)
    frozen = dict(fixed_hw=GEMMINI_DEFAULT, fix_pe_only=True)

    def learned(kind):
        m = models[kind]
        return dict(surrogate=m, latency_model=calibration.predicted_edp_fn(
            m, pe_dim=GEMMINI_DEFAULT.pe_dim))

    variants = {"analytical": {}, "dnn": learned("direct"),
                "combined": learned("residual")}
    out = {}
    for name, extra in variants.items():
        cfg = search.SearchConfig(**FIG12, **frozen, **extra)
        torch.cuda.synchronize()
        t0 = now()
        res = search.dosa_search(wl, cfg, population=3, device="cuda")
        secs = now() - t0
        replay = search._oracle_edp(res.best_mappings, wl, cfg,
                                    search._cspec(cfg))
        check(replay == res.best_edp, f"{name}: oracle re-evaluation "
              f"{replay} != best_edp {res.best_edp}")
        edp_rtl = rtl_sim.rtl_workload_edp(res.best_mappings, wl.layers,
                                           res.best_hw)
        out[name] = {"search_seconds": secs, "n_evals": res.n_evals,
                     "best_edp": res.best_edp, "rtl_edp": edp_rtl,
                     "vs_default": edp_default / edp_rtl,
                     "acc_kb": res.best_hw.acc_kb,
                     "sp_kb": res.best_hw.sp_kb}
    short = search.SearchConfig(**FIG12_SHORT, **frozen,
                                **variants["combined"])
    r = {fused: search.dosa_search(wl, short, population=3, fused=fused,
                                   device="cuda")
         for fused in (True, False)}
    check(r[True].best_edp == r[False].best_edp
          and r[True].n_evals == r[False].n_evals
          and r[True].history == r[False].history,
          f"combined short search: fused {r[True].best_edp} / "
          f"{r[True].n_evals} != host-batched {r[False].best_edp} / "
          f"{r[False].n_evals}")
    emit({"phase": "calibrated_search_unet", "layers": len(wl.layers),
          "protocol": FIG12, "population": 3, "fixed_pe_dim":
              GEMMINI_DEFAULT.pe_dim,
          "default_rtl_edp": edp_default, "variants": out,
          "short_protocol": FIG12_SHORT,
          "short_combined_fused_equals_host_batched": True,
          "short_combined_best_edp": r[True].best_edp,
          "short_combined_n_evals": r[True].n_evals, "cuts": CUTS})
    return wl, short, r[True]


def phase_baselines_resnet50(random_search, wl, res):
    """Random search (Fig. 7's baseline, host numpy) on ResNet-50 with
    10 hardware designs and about the co-search's sample count."""
    n_hw = 10
    n_map = max(round(res.n_evals / (n_hw * len(wl.layers))), 1)
    t0 = now()
    best, history = random_search(wl, n_hw=n_hw, n_map=n_map, seed=0)
    secs = now() - t0
    emit({"phase": "baselines_resnet50", "method": "random_search",
          "n_hw": n_hw, "n_map": n_map, "samples": history[-1][0],
          "dosa_n_evals": res.n_evals, "host_seconds": secs,
          "best_edp": best, "dosa_best_edp": res.best_edp,
          "ratio_to_dosa": best / res.best_edp})


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
    """Kernel (the wgmma variant), plain version and torch.matmul at the
    main shape; 10 back-to-back calls per timed run."""
    m, k = x.shape
    n = y.shape[1]
    blocks = dict(bm=m, bk=k, bn=n)
    before = dict(matmul.launches_by_variant)
    kern = matmul(x, y, **blocks)
    ran_on(matmul.launches_by_variant, before, "wgmma", "matmul timing")
    ref = matmul_ref(x, y)
    err = (kern.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: matmul(x, y, **blocks), reps=10)
    plain_ms = cuda_ms(lambda: matmul_ref(x, y), reps=10)
    library_ms = cuda_ms(lambda: torch.matmul(x, y), reps=10)
    flops = 2.0 * m * n * k
    nbytes = (m * k + k * n + m * n) * x.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"name": "matmul", "variant": "wgmma", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/matmul.cu",
           "replaces": "src/repro/kernels/matmul/matmul.py:24",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms, "held_against_plain": True}
    emit({"phase": "matmul_timing", "shape": [m, k, n], "dtype": str(x.dtype),
          "flops": flops, "bytes": nbytes,
          "tflops": flops / (ms * 1e-3) / 1e12,
          "tc_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS, **row})
    return row


def plain_attention(attention_ref, q, k, v, causal, q_offset):
    """The plain version at the kernel's (B, H, S, D) GQA interface:
    KV heads repeated, heads flattened, `attention_ref`."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, 1).reshape(b * hq, -1, d)
    vv = v.repeat_interleave(group, 1).reshape(b * hq, -1, d)
    return attention_ref(q.reshape(b * hq, sq, d), kk, vv, causal=causal,
                         q_offset=q_offset).reshape(q.shape)


def phase_flash_vs_plain(torch, attend, attention_ref, flash):
    """Every FLASH_CASES shape, f32 and bf16, on the card against the
    plain version; bf16 always on wgmma, f32 always on simt."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for (b, hq, hkv, sq, sk, d, causal, off) in FLASH_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((b, hq, sq, d), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((b, hkv, sk, d), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((b, hkv, sk, d), generator=gen,
                            device="cuda").to(dt)
            before = dict(flash.launches_by_variant)
            out = attend(q, k, v, causal=causal, q_offset=off)
            ran_on(flash.launches_by_variant, before,
                   "wgmma" if dt == torch.bfloat16 else "simt",
                   f"flash {(b, hq, hkv, sq, sk, d, causal, off)} {dt}")
            ref = plain_attention(attention_ref, q, k, v, causal, off)
            torch.cuda.synchronize()
            key = str(dt).split(".")[-1]
            tol = FLASH_TOL[key]
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)
            err = (out.float() - ref.float()).abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err)
    emit({"phase": "flash_vs_plain",
          "cases_b_hq_hkv_sq_sk_d_causal_qoffset": FLASH_CASES,
          "variants": {"float32": "simt", "bfloat16": "wgmma"},
          "max_abs_err": worst, "tolerance": FLASH_TOL})


def phase_lm_prefill(torch, lm_mod, configs, flash):
    """The LM main path: Qwen3-0.6B at full width, initialised on the
    card from seed 0, `prefill` of 4 prompts x 4096 tokens — a cold
    call, then a warm one, the flash launches counted in each."""
    cfg = configs.get_config("qwen3_0_6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = lm_mod.build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, launches, on_wgmma = [], [], []
    for _ in range(2):
        flash.launches = 0
        flash.launches_by_variant.update(wgmma=0, simt=0)
        t0 = now()
        logits, cache = model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(now() - t0)
        launches.append(flash.launches)
        on_wgmma.append(flash.launches_by_variant["wgmma"])
    check(launches == [cfg.n_layers] * 2 and on_wgmma == launches,
          f"flash launches per prefill call {launches}, {on_wgmma} on "
          f"wgmma; expected {cfg.n_layers}, all on wgmma")
    finite = bool(torch.isfinite(logits).all())
    check(finite, "prefill logits finite")
    check(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab_size),
          f"prefill logits shape {tuple(logits.shape)}")
    k_stack = cache["kv"][0][0]
    check(tuple(k_stack.shape) == (cfg.n_layers, PREFILL_B, cfg.n_kv_heads,
                                   PREFILL_S, cfg.head_dim),
          f"KV stack shape {tuple(k_stack.shape)}")
    tokens_n = PREFILL_B * PREFILL_S
    emit({"phase": "lm_prefill_qwen3_0_6b", "batch": PREFILL_B,
          "prompt_len": PREFILL_S, "compute_dtype": cfg.compute_dtype,
          "seconds_cold": secs[0], "seconds_warm": secs[1],
          "tokens_per_s_warm": tokens_n / secs[1],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "flash_launches_per_call": launches,
          "flash_wgmma_launches_per_call": on_wgmma,
          "logits_finite": finite})
    return model, launches[0]


def phase_lm_serve(torch, serve, configs, flash):
    """The serve path at full width: the CLI's `run` with 4 requests,
    prompt 128, 32 generated tokens, greedy."""
    argv = ["--arch", "qwen3_0_6b", "--batch", "4", "--prompt-len", "128",
            "--gen", "32", "--device", "cuda", "--seed", "0"]
    args = serve.parse_args(argv)
    flash.launches = 0
    seq, secs = serve.run(args, clock=now)
    vocab = configs.get_config("qwen3_0_6b").vocab_size
    check(tuple(seq.shape) == (4, 160), f"served tokens {tuple(seq.shape)}")
    check(bool(((seq >= 0) & (seq < vocab)).all()), "tokens in range")
    emit({"phase": "lm_serve_qwen3_0_6b", "argv": argv,
          "seconds": secs, "tok_per_s": seq.numel() / secs,
          "flash_launches": flash.launches,
          "sample": seq[0, 120:140].tolist()})


def phase_profile_prefill(torch, model, top: int = 12):
    """Where a warm full-width prefill's device time goes: one call of
    4 x 4096 tokens under torch.profiler; device time in total, in the
    flash kernel, in cuBLAS matrix products and in the rest, and the
    `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(1, model.cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    model.prefill({"tokens": tokens})                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        model.prefill({"tokens": tokens})
        torch.cuda.synchronize()
        wall_ms = (now() - t0) * 1e3
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    flash = sum(t for n, t in by_name.items() if "flash_fwd_wgmma" in n)
    gemm = sum(t for n, t in by_name.items()
               if any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass")))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    emit({"phase": "profile_prefill", "batch": PREFILL_B,
          "prompt_len": PREFILL_S, "wall_ms_profiled": wall_ms,
          "device_ops": n_ops,
          "device_busy_ms": busy if n_ops else "not measured",
          "flash_ms": flash, "cublas_gemm_ms": gemm,
          "other_ms": busy - flash - gemm,
          "top_kernels_ms": {n[:100]: t for n, t in ranked}})


def phase_profile_decode(torch, model, n_steps: int = 5):
    """Where a full-width decode step's time goes: `n_steps` steps of
    4 sequences at positions 128.. timed on the host clock, then the
    same under torch.profiler — device operations, device busy time and
    busy share per step."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(5)
    tok = torch.randint(1, model.cfg.vocab_size, (4, 1), generator=gen,
                        device="cuda")
    cache = model.init_cache(4, 160)
    model.decode_step(cache, tok, 127)                      # warm
    torch.cuda.synchronize()
    t0 = now()
    for i in range(n_steps):
        model.decode_step(cache, tok, 128 + i)
    torch.cuda.synchronize()
    step_ms = (now() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            model.decode_step(cache, tok, 128 + i)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_steps
    emit({"phase": "profile_decode_steps", "steps": n_steps, "batch": 4,
          "wall_ms_per_step": step_ms,
          "device_ops_per_step": len(dev) / n_steps,
          "device_busy_ms_per_step": busy_ms if dev else "not measured",
          "device_busy_share": busy_ms / step_ms if dev
          else "not measured"})


def phase_lm_prefill_vs_decode(torch, lm_mod, model):
    """Teacher-forced `decode_step` over a 128-token prompt against
    `prefill` of it, at full width: the last logits and the K/V stacks.
    Float32 compute (f32 cache) is held to DECODE_TOL_F32; the bf16
    compute's error (bf16 cache) is printed beside it."""
    import dataclasses

    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(1, model.cfg.vocab_size, (2, 128),
                           generator=gen, device="cuda")
    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(model.cfg, compute_dtype=cdt)
        m = lm_mod.build_model(cfg, device="cuda", params=model.params)
        logits_p, cache_p = m.prefill({"tokens": tokens})
        dtype = getattr(torch, cdt)
        cache = m.init_cache(2, 128, dtype=dtype)
        for pos in range(128):
            logits_d, cache = m.decode_step(cache, tokens[:, pos:pos + 1],
                                            pos)
        torch.cuda.synchronize()
        pairs = [("logits", logits_d, logits_p),
                 ("k", cache["slot0"]["k"], cache_p["kv"][0][0]),
                 ("v", cache["slot0"]["v"], cache_p["kv"][0][1])]
        errs = {}
        for name, a, b in pairs:
            errs[name] = (a.float() - b.float()).abs().max().item()
            if cdt == "float32":
                torch.testing.assert_close(a.float(), b.float(),
                                           rtol=DECODE_TOL_F32,
                                           atol=DECODE_TOL_F32)
        out[cdt] = errs
    emit({"phase": "lm_prefill_vs_decode", "prompt_len": 128, "batch": 2,
          "tolerance_f32": DECODE_TOL_F32,
          "max_abs_err_f32": out["float32"],
          "max_abs_err_bf16_printed_only": out["bfloat16"]})


def phase_lm_card_vs_cpu(torch, lm_mod, configs, serve_step):
    """The reduced config in float32: parameters drawn on the CPU, the
    same tree on the card; prefill logits within 1e-4, greedy tokens
    equal."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("qwen3_0_6b", reduced=True),
                              compute_dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu = lm_mod.build_model(cfg, device="cpu", generator=gen)
    card = lm_mod.build_model(
        cfg, device="cuda",
        params=lm_mod._tree_map(lambda t: t.to("cuda"), cpu.params))
    tokens = torch.randint(1, cfg.vocab_size, (2, 40), generator=gen)
    lc, _ = cpu.prefill({"tokens": tokens})
    lg, _ = card.prefill({"tokens": tokens.cuda()})
    err = (lg.cpu() - lc).abs().max().item()
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    tc = serve_step.greedy_decode(cpu, tokens[:, :8], 12, device="cpu")
    tg = serve_step.greedy_decode(card, tokens[:, :8], 12, device="cuda")
    check(torch.equal(tc, tg.cpu()), "greedy tokens card != cpu")
    emit({"phase": "lm_card_vs_cpu", "config": "qwen3_0_6b reduced f32",
          "prefill_logits_max_abs_err": err, "tolerance": 1e-4,
          "greedy_tokens_equal": True})


def phase_flash_timing(torch, attend, attention_ref, flash, launches):
    """Kernel (the wgmma variant), plain version and SDPA at the prefill
    shape, bf16 causal (10 back-to-back kernel and SDPA calls per timed
    run); then the float32 simt kernel once at the same shape."""
    import torch.nn.functional as F

    b, hq, hkv, s, d = PREFILL_B, 16, 8, PREFILL_S, 128
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((b, hq, s, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hkv, s, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    before = dict(flash.launches_by_variant)
    kern = attend(q, k, v, causal=True)
    ran_on(flash.launches_by_variant, before, "wgmma", "flash timing")
    ref = plain_attention(attention_ref, q, k, v, True, 0)
    err = (kern.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(kern.float(), ref.float(),
                               rtol=FLASH_TOL["bfloat16"],
                               atol=FLASH_TOL["bfloat16"])
    del ref
    group = hq // hkv
    qf = q.reshape(b * hq, s, d)
    kf = k.repeat_interleave(group, 1).reshape(b * hq, s, d)
    vf = v.repeat_interleave(group, 1).reshape(b * hq, s, d)
    ms = cuda_ms(lambda: attend(q, k, v, causal=True), reps=10)
    plain_ms = cuda_ms(lambda: attention_ref(qf, kf, vf, causal=True),
                       warmup=1, iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=10)
    del qf, kf, vf
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = dict(flash.launches_by_variant)
    attend(q32, k32, v32, causal=True)
    ran_on(flash.launches_by_variant, before, "simt", "f32 flash timing")
    simt_f32_ms = cuda_ms(lambda: attend(q32, k32, v32, causal=True),
                          warmup=1, iters=5)
    del q32, k32, v32
    pairs = b * hq * s * (s + 1) // 2           # visible (q, k) pairs
    flops = 4.0 * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"name": "flash_attention", "variant": "wgmma", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces":
               "src/repro/kernels/flash_attention/flash_attention.py:26",
           "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms, "held_against_plain": True}
    emit({"phase": "flash_timing", "shape_b_hq_hkv_s_d": [b, hq, hkv, s, d],
          "dtype": "bfloat16", "causal": True, "flops": flops,
          "bytes": nbytes, "tflops": flops / (ms * 1e-3) / 1e12,
          "tc_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
          "library": "scaled_dot_product_attention(enable_gqa=True)",
          "simt_f32_ms": simt_f32_ms,
          "simt_f32_tflops": flops / (simt_f32_ms * 1e-3) / 1e12, **row})
    return row


def ptxas_summary(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    in an `nvcc -Xptxas=-v` report, by mangled name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit:
            out[name]["spill_stores"] = int(hit.group(1))
            out[name]["spill_loads"] = int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def build_all(build, names):
    """Build every kernel library at once, one nvcc each; print each
    kernel's registers, spills and static shared memory (the wgmma
    kernels' shared memory is dynamic: 197,696 B for the matmul,
    164,904 B for flash at D 128) and the full compiler report."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = now()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(build.build, names))
    logs = {n: p.with_suffix(".log").read_text()
            for n, p in zip(names, paths)}
    emit({"phase": "build", "seconds": now() - t0,
          "libraries": [p.name for p in paths],
          "ptxas_summary": {n: ptxas_summary(log) for n, log in logs.items()},
          "ptxas": logs})


def main() -> int:
    import torch

    t_start = now()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import (calibration, cosa, oracle, problem,
                                  rtl_sim, search, surrogate)
    from repro_torch.core.arch import GEMMINI_DEFAULT
    from repro_torch.core.baselines import random_search
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        attend, flash_attention)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.matmul.matmul import matmul
    from repro_torch.kernels.matmul.ops import tuned_blocks, tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_mod
    from repro_torch.serve import serve_step
    from repro_torch.workloads import dnn_zoo

    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_all(build, ["matmul", "flash_attention"])
    phase_kernel_vs_plain(torch, matmul, matmul_ref)
    phase_flash_vs_plain(torch, attend, attention_ref, flash_attention)

    # ---- main path 1: tuned matmul + co-search, counts from 0.
    matmul.launches = 0
    matmul.launches_by_variant.update(wgmma=0, simt=0)
    flash_attention.launches = 0
    x, y = phase_tuned_matmul(torch, tuned_matmul, tuned_blocks, matmul_ref,
                              matmul)
    wl, cfg, res = phase_cosearch(torch, search, oracle, dnn_zoo)
    mm_launches = matmul.launches_by_variant["wgmma"]
    check(mm_launches > 0,
          "the tuned path never launched the wgmma matmul kernel")
    emit({"phase": "main_path_launches", "path": "tuned_matmul+cosearch",
          "matmul": mm_launches,
          "matmul_by_variant": dict(matmul.launches_by_variant),
          "flash_attention": flash_attention.launches})

    # ---- main path 2: LM prefill at full width, counts from 0 per call.
    matmul.launches = 0
    matmul.launches_by_variant.update(wgmma=0, simt=0)
    model, fa_launches = phase_lm_prefill(torch, lm_mod, configs,
                                          flash_attention)
    check(fa_launches > 0, "prefill never launched the flash kernel")
    emit({"phase": "main_path_launches", "path": "lm_prefill",
          "matmul": matmul.launches, "flash_attention": fa_launches,
          "flash_attention_by_variant":
              dict(flash_attention.launches_by_variant)})

    # ---- main path 3: the serve loop at full width.
    phase_lm_serve(torch, serve, configs, flash_attention)

    phase_profile_prefill(torch, model)
    phase_profile_decode(torch, model)
    phase_lm_prefill_vs_decode(torch, lm_mod, model)
    del model
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu(torch, lm_mod, configs, serve_step)
    phase_chunk_sync_free(torch, search, wl, cfg, res)
    gd_resnet50 = phase_profile_gd(torch, search, wl, cfg)
    phase_card_vs_cpu(search, problem)

    # ---- the paper's Sec. 6 experiments, counts from 0 (no kernel of
    # this repo is on these paths).
    matmul.launches = 0
    matmul.launches_by_variant.update(wgmma=0, simt=0)
    flash_attention.launches = 0
    models = phase_calibration_train(torch, np, surrogate, rtl_sim, dnn_zoo,
                                     GEMMINI_DEFAULT)
    unet, short_cfg, short_res = phase_calibrated_search_unet(
        torch, search, calibration, rtl_sim, cosa, dnn_zoo, GEMMINI_DEFAULT,
        models)
    phase_chunk_sync_free(torch, search, unet, short_cfg, short_res,
                          phase="surrogate_chunk_sync_free")
    gd_unet = phase_profile_gd(torch, search, unet, short_cfg,
                               phase="profile_gd_steps_surrogate")
    emit({"phase": "profile_gd_surrogate",
          "unet_combined_surrogate": gd_unet,
          "resnet50_analytical": gd_resnet50})
    phase_baselines_resnet50(random_search, wl, res)
    emit({"phase": "main_path_launches",
          "path": "calibration+calibrated_search+baselines",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches})
    mm_row = phase_matmul_timing(torch, matmul, matmul_ref, x, y,
                                 mm_launches)
    fa_row = phase_flash_timing(torch, attend, attention_ref,
                                flash_attention, fa_launches)

    emit({"phase": "total", "seconds": now() - t_start})
    emit({"kernels": [mm_row, fa_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
