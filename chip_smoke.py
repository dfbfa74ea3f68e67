#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels
(the matmul, the flash attention and its backward, one nvcc each, in
parallel) from the sources in the checkout and prints the compiler's
register, spill and shared-memory report.  Each kernel has two
variants: "wgmma" (tensor cores and TMA, for bfloat16) and "simt" (IEEE
float32 FMA, for float32 and for bfloat16 matmul shapes TMA cannot
take).  It holds each against its plain PyTorch
version on the card (the backward: dq, dk, dv of the differentiable
entry against autograd through the plain forward, and the forward's
log-sum-exp), checking from the per-variant launch counts which
variant each case ran, and drives the port's paths through the entry
points a user calls, each with the launch counts set to 0 just before
it and read just after:

- the DOSA-tuned matmul at Qwen3-0.6B's FFN up-projection width, then
  the DOSA co-search at the paper's protocol on ResNet-50;
- `LM.prefill` of Qwen3-0.6B at full width (4 prompts x 4096 tokens),
  whose attention runs in the flash kernel, 28 launches a call;
- the serve loop (`launch.serve`) at full width: 4 requests, prompt
  128, 32 generated tokens, greedy.

Then it profiles a prefill call and decode steps, checks the card
against the CPU (the reduced LM) and teacher-forced decode against
prefill at full width.  The training path comes next, counts set to 0:

- `lm_train_qwen3_0_6b`: `launch.train` at its defaults on Qwen3-0.6B
  at full width and depth (batch 8 x seq 512, bf16 compute, AdamW,
  remat), 6 steps through `train_with_recovery` with a checkpoint every
  3 and a RuntimeError injected at step 4, then the same 6 steps
  uninterrupted: one restart, finite losses, the steps after the
  rollback equal to the uninterrupted run's, and 56 forward and 28
  backward flash launches a step, every bf16 backward on its wgmma
  kernel; `lm_serve_ckpt`: the serve CLI's `run` with `--ckpt-dir` on
  the uninterrupted run's checkpoint, whose tokens must equal serving
  the trained model directly; a profiled step; the reduced LM's
  training on the card against the CPU.

Training over a training mesh comes next, counts set to 0 between the
phase's unsharded reference run and its DTensor run, so that they count
the DTensor path alone:

- `dist_train_one_card`: Qwen3-0.6B at full width, 3 AdamW steps of 8
  x 512 (bf16 compute, remat), then the reduced configs of the five
  other families (Phi-3.5-MoE, Mamba-2, Jamba, Llama-3.2-Vision,
  HuBERT-XLarge) in float32 compute, 3 steps of 4 x 128 each on their
  configs' optimizers, through the DTensor path
  (`make_train_step(model, tcfg, mesh)`: the MoE's experts and the
  SSD's heads on local shards) over an NCCL world of one process,
  mesh (1, 1, 1), each against the same 3 steps of the unsharded step
  from the same seed: losses bit-equal (and the reduced configs'
  parameters), per attention call 2 forward (remat) and 1 backward
  flash launches a step (wgmma for bf16, simt for float32), exactly 3
  steps' worth of each in the path's counts, the collective census 0,
  the phase within 45 s.  `chip_dist_train.py` runs the mesh over
  four cards.
- `dist_serve_one_card`: prefill and decode over the same kind of mesh
  (counts set to 0 between its unsharded run and its mesh run):
  Qwen3-0.6B at full width in float32, `LM.prefill` of 4 x 1024 and 8
  greedy decode steps against the unsharded model from the same seed
  (the mesh fed its tokens): logits and K/V within 1e-5 of the largest
  magnitude, equal picks, one simt flash launch a layer in the
  prefill and none decoding, the census 0, the phase within 45 s.

The other families train next at their configs' published widths,
counts set to 0 before each, 4 steps of 8 x 512 tokens (HuBERT: frames)
through `make_train_step` on the config's optimizer (bf16 compute,
remat), each step's attention calls and flash launches gated (2
forward and 1 backward launch a call, all on wgmma, at the config's
head dim):

- `lm_train_mamba2_1_3b` (whole, 48 SSD layers, no flash launch),
  `lm_train_phi3_5_moe_42b` (2 of 32 layers: the MoE router, dispatch
  and expert products under autograd), `lm_train_hubert_xlarge` (whole,
  full attention at D 80), `lm_train_gemma_7b` (4 of 28 layers, D 256;
  one step profiled by kernel), `lm_train_llama_3_2_vision_90b` (one
  period, 5 of 100 layers, with its cross-attention over 4096 image
  embeddings; Adafactor on bf16 parameters);
- `lm_train_families_card_vs_cpu`: the six families' reduced configs,
  3 float32 steps, each step from the same state on the card and the
  CPU, losses and parameters within the CPU tolerances; the MoE
  router's picks compared.

The other families' serving paths come next, counts set to 0 before
each, each at its config's full width (one period where the whole
model does not fit the card), prefill of 4 x 4096 and the serve loop
of 4 requests (prompt 128, 32 generated) through `serve_step`, with
every attention call's shape gated:

- `lm_prefill_jamba_period` / `lm_serve_jamba_period`: Jamba-v0.1, 8
  of its 32 layers (1 attention, 7 SSD, 4 MoE of 16 experts top-2, 4
  dense FFN); one causal flash launch a prefill;
- `lm_prefill_mamba2_1_3b` / `lm_serve_mamba2_1_3b`: Mamba-2 1.3B,
  whole; no flash launch; prefill's last logits against stepping
  `decode_step` through a 512-token prompt;
- `lm_prefill_llama_vision_period` / `lm_serve_llama_vision_period`:
  Llama-3.2-Vision-90B, 5 of its 100 layers, 4096 image embeddings a
  row; 5 causal and 1 cross launch a prefill, one cross launch with
  Sq = 1 a decode step;
- `lm_encode_hubert_xlarge`: HuBERT-XLarge, whole, on 4 x 4096 frames;
  48 full-attention launches at head dim 80;
- `lm_families_card_vs_cpu`: the six families' reduced configs in
  float32, prefill and 3 decode steps on the card against the CPU.

Then GD steps are profiled and a small search compared card to CPU.
The paper's Sec. 6 experiments come next, with the counts again set to
0:

- `calibration_train`: the Fig. 10 training set (AlexNet, ResNeXt-50,
  VGG-16, DeepBench; 31 random mappings a layer) labelled by the RTL
  stand-in, the residual and direct latency models trained on the card
  (300 epochs each), their held-out Spearman beside the analytical
  model's, and 20 epochs on the card against the CPU;
- `calibrated_search_unet`: the Fig. 12 protocol on UNet (16x16 array
  frozen; 250 GD steps rounded every 125, cut from the paper's 1490
  for time) with the analytical, DNN-only and combined latency models,
  judged by the RTL stand-in against the default Gemmini; the combined
  search's fused and host-batched engines held equal on a short config;
- `surrogate_chunk_sync_free` and `profile_gd_surrogate`: one chunk of
  that short combined search free of host syncs, and its GD steps
  profiled beside ResNet-50's analytical ones;
- `baselines_resnet50`: random search (host numpy) with about the
  ResNet-50 co-search's sample count.

Then the co-search service, counts again set to 0:

- `device_seed`: ResNet-50's dims, 1024 members, both seeding modes,
  on the card under set_sync_debug_mode("error"), against the CPU and
  the host twin on the same uniforms;
- `device_seeded_search_resnet50`: 256 starts seeded on the card
  (start_points="cosa-device"), 250 GD steps rounded every 125 (cut
  from the paper's 1490 for time), GD steps profiled at P=256;
- `fleet_resnet50`: ResNet-50 over Gemmini, TPU v5e and the edge spec
  (two engine groups), then fleet against single-target search on the
  small config;
- `service_http`: a `CoSearchServer` on the card answering 8 HTTP
  requests (a same-spec batch padded to member bucket 4, a mixed-spec
  group, a duplicate, a ResNet-50 request, a malformed one), each
  answer against a direct search on the card; kill/resume from a
  checkpoint; a seeded chaos schedule that injects transient faults
  (rolled back and retried) and torn checkpoints, each gated on its
  own; the reference's metric families and span names.

Then population sharding, counts again set to 0:

- `pop_shards`: the ResNet-50 device-seeded fused search (P = 256, 50
  GD steps rounded once) at 1, 2 and 4 shards over repeated cuda:0,
  one host thread and one stream a shard, and over every card when
  there are several: each shard count's `best_edp`, `n_evals` and
  `history` equal one shard's; one chunk's rounded read-back (two
  segments of 5 steps) at 2 and 4 shards bit-equal to one shard's, its
  reduced best the unsharded tracker's argmin; the tiny fleet (TPU v5e
  + edge) at 2 shards equal to 1; one service request at shards=2 under
  an injected `ShardLossFault`, degraded to one shard with
  ("shard_fallback",) and the direct answer. Seconds of each search,
  not gated.

The static-analysis suite (`repro_torch.analysis`) runs in two phases:

- `analysis_lint` (host, right after the build): the port's lint over
  this checkout's `src/repro_torch` against its baseline, with no new
  finding, and the spec lint of the shipped specs, clean;
- `analysis_contracts` (after the service, counts again set to 0): the
  engine contracts on the card (transfer-free under the dispatch
  recorder and set_sync_debug_mode("error"), for the search and fleet
  engines also one chunk split over two shards of the card, each
  shard's worker recorded; one engine build across populations 2 and
  4, no float64, the op-sequence fingerprint) for the search, fleet
  and service paths, every check gated; two negative
  controls (`.item()`, `nonzero()`) that must fail `transfer_free` on
  the card; and the same contracts on the CPU, whose search fingerprint
  is printed beside the card's (equality reported, not gated).

The dry-run (`repro_torch.launch.cells`, every step traced on the
meta device) runs in three phases:

- `dryrun_cells` and `hillclimb_qwen3` (host, right after the lint):
  `run_cell` on the 16x16 mesh for DRYRUN_CELLS, every applicable cell
  counted and every skip with the reference's reason, the counts within
  DRYRUN_BUDGET_S, each with its per-device FLOPs, bytes, memory and
  H100 roofline terms; each counted cell (the train cells of
  Qwen3-0.6B, Kimi K2 and Nemotron-4, Qwen3's prefill_32k and
  decode_32k, Jamba's and Mamba-2's long_500k) also with its collective
  census by kind, taken over a fake "cuda" production mesh (NCCL's
  plans; no card used: the card's allocated and peak bytes are gated
  unchanged), Qwen3's train all-to-all > 0, each decode cell's census
  below its cache's bytes a device (the decode step keeps the weights
  and the cache in place), Qwen3's train census free of any collective
  whose last dim is its whole vocabulary (the loss runs on the logits'
  vocabulary shards) and at least QWEN3_TRAIN_CUT_GB below
  QWEN3_TRAIN_GATHERED_GB, the censuses within
  DRYRUN_CENSUS_BUDGET_S; `hillclimb.run`'s
  "baseline" and "no_remat" on Qwen3-0.6B train_4k, whose compute
  term must fall and whose collective term must be above 0;
- `dryrun_vs_card` on a one-device mesh, for Qwen3-0.6B training (8 x
  512) and prefill (4 x 4096) after the Qwen3 training section, and for
  Gemma-7B's 4-layer training on the model `lm_train_gemma_7b` built:
  the meta FLOP count equals FlopCounterMode around a real step on the
  card, op by op; the meta argument bytes equal the card's parameters,
  optimizer state and batch; the H100 roofline step is at most the
  measured step.  The flash kernels are custom ops
  (`repro_torch::flash_fwd`, `repro_torch::flash_bwd`), so the counter
  sees them on the card by their FLOP formula.

After the co-search, `example_torch_quickstart` runs
`examples/torch_quickstart.py` on the card in a process of its own and
holds its best EDP to the oracle's.

Last, it times the three kernels (the wgmma variants of the main path,
the float32 flash on its simt kernel, the flash forward and backward
also at HuBERT's head dim 80 and Gemma's 256, and the backward at the
training shape) beside their bounds, plain versions and library
calls.
Each phase prints one JSON line; any failure raises and exits non-zero.
The second-to-last lines are the kernel summary and the card's name and
power limit (from nvidia-smi); the last line is
``{"ok": true, "device": {...}}``.

It imports torch and the port only, never jax or the JAX reference.
All timing lives here (the package reads no clock).
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_T0 = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.arch import H100_SXM  # noqa: E402

# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit):
# the port's roofline target, and its float32 rate outside the tensor
# cores.
PEAK_BF16_FLOPS = H100_SXM.peak_flops
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = H100_SXM.hbm_bw

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
# (Sk = 4133 not a multiple of the 128-key tile).  Then the other head
# dims of the model configs: HuBERT-XLarge's 80 (its 16 heads, full
# attention), Kimi K2's 112 (GQA 8 over 1, after a prefix), Nemotron-4's
# 192 and Gemma-7B's 256 (64-key tiles on wgmma), ragged and causal or
# full; and the cross-attention shapes of Llama-3.2-Vision: 128 text
# queries over 4096 image keys, and one decode query over them.
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
    (2, 16, 16, 512, 512, 80, False, 0), (1, 4, 2, 300, 300, 80, True, 0),
    (1, 8, 1, 200, 333, 112, True, 133), (1, 4, 4, 257, 257, 112, False, 0),
    (1, 4, 2, 300, 300, 192, True, 0), (1, 4, 4, 200, 333, 192, False, 0),
    (1, 4, 4, 300, 300, 256, True, 0), (2, 4, 2, 100, 1000, 256, True, 900),
    (1, 4, 4, 1, 700, 256, False, 0),
    (2, 8, 2, 128, 4096, 128, False, 0), (4, 8, 2, 1, 4096, 128, False, 0),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# A bf16 case's absolute bound shrinks with its plain output: 2e-2 times
# the output's largest magnitude where that is below 1.  Full attention
# over thousands of random keys averages them down to outputs of about
# 0.03 (largest about 0.13), where a flat 2e-2 would pass a kernel that
# skips a whole key tile; the kernel's error there is one bf16 step of
# the output, 2**-10.  Every full-attention case with two or more key
# tiles is also held to the other side: the plain output without keys
# MISSING_TILE (one 128-key tile) must fail the bound.
MISSING_TILE = (128, 256)
# The flash kernel timed beyond the Qwen3 prefill shape: HuBERT-XLarge's
# encoder (16 heads of 80, full attention) and Gemma-7B's prefill (16
# heads of 256, causal), 4 x 4096 tokens each; (shape, causal, seed).
FLASH_TIMING_SHAPES = [((4, 16, 16, 4096, 80), False, 7),
                       ((4, 16, 16, 4096, 256), True, 8)]
# The flash backward against autograd through the plain version: (b, hq,
# hkv, sq, sk, d, causal, q_offset).  Every head dim, query groups of 1
# and 2, causal and full, sequences that are no multiple of the 64-row
# tiles, a causal query block after a prefix, the training shape of
# Qwen3-0.6B's attention at batch 2, and the forward's long ragged case
# (Sk = 4133 no multiple of a 64- or 128-key tile, after a prefix).
# Then the other head dims of the model configs: HuBERT-XLarge's 80
# (full, ragged Sq and Sk), Kimi K2's 112 (GQA 8 over 1, causal after a
# prefix), Nemotron-4's 192 (causal, GQA) and Gemma-7B's 256 (full and
# causal, the split 64-row tiles on wgmma), and a long full case of 128
# queries over 4096 keys with GQA 8 over 1.  Last, the attention shapes
# of the family training phases (TRAIN_FAMILIES) at batch 2: HuBERT-
# XLarge (16 heads of 80, full), Gemma-7B (16 of 256, causal), Phi-3.5-
# MoE (32 over 8 KV heads of 128, causal), Llama-3.2-Vision's self-
# attention (64 over 8, causal) and its cross-attention (512 text
# queries over 4096 image keys, full).
# Tolerance: the largest error of each gradient within this share of
# the plain gradient's largest magnitude.
FLASH_BWD_CASES = [
    (1, 2, 2, 77, 77, 32, True, 0), (1, 4, 2, 200, 200, 64, False, 0),
    (2, 4, 2, 300, 300, 128, True, 0), (1, 2, 1, 130, 130, 128, False, 0),
    (1, 4, 4, 100, 300, 64, True, 200), (1, 2, 1, 333, 333, 32, False, 0),
    (2, 16, 8, 512, 512, 128, True, 0),
    (1, 16, 8, 130, 4133, 128, True, 4003),
    (2, 4, 4, 200, 333, 80, False, 0), (1, 4, 2, 300, 300, 80, True, 0),
    (1, 8, 1, 200, 333, 112, True, 133), (1, 4, 4, 257, 257, 112, False, 0),
    (1, 4, 2, 300, 300, 192, True, 0), (1, 4, 4, 200, 333, 192, False, 0),
    (1, 4, 4, 257, 257, 256, False, 0), (2, 4, 2, 100, 1000, 256, True, 900),
    (1, 4, 4, 300, 300, 256, True, 0),
    (2, 8, 1, 128, 4096, 128, False, 0),
    (2, 16, 16, 512, 512, 80, False, 0), (2, 16, 16, 512, 512, 256, True, 0),
    (2, 32, 8, 512, 512, 128, True, 0), (2, 64, 8, 512, 512, 128, True, 0),
    (2, 64, 8, 512, 4096, 128, False, 0),
]
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The forward's log-sum-exp against the plain one (either type: the
# scores are float32 sums of exact products).
FLASH_LSE_TOL = 1e-4

# Qwen3-0.6B prefill: 4 prompts x 4096 tokens; one cold call, then
# PREFILL_WARM warm ones.
PREFILL_B, PREFILL_S = 4, 4096
PREFILL_WARM = 5
# Qwen3-0.6B training through `launch.train` at its defaults (batch 8 x
# seq 512, bf16 compute, f32 params, AdamW, remat, seed 0): 6 steps,
# a checkpoint every 3, one injected RuntimeError at step 4; then the
# same 6 steps uninterrupted (one checkpoint, at the end), whose losses
# the steps after the rollback must match within TRAIN_ROLLBACK_RTOL.
# A checkpoint of the whole state is 9 GB and takes 10-19 s to write:
# every 3 steps writes two in the faulty run where every 2 wrote four.
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_STEP = 6, 3, 4
TRAIN_ROLLBACK_RTOL = 1e-3
# The reduced config in f32, 3 steps, card against CPU: the CPU parity
# tolerances of tests/test_torch_train.py (losses rtol 1e-5, parameters
# rtol and atol 1e-4).
TRAIN_CARD_CPU = dict(loss_rtol=1e-5, param_tol=1e-4)
# The families' reduced configs, card against CPU from the same state:
# each step's gradient norm (rtol, as the CPU test against the reference
# holds it) and each parameter leaf's gradient, its largest error within
# this share of the leaf's largest CPU gradient.  The optimizers barely
# see a gradient's scale (AdamW's first step moves each element by about
# lr * sign(g)), so the parameters alone would pass a backward wrong by
# a factor.  tests/torch_adam_drift_card.py read every leaf within
# 3.8e-5 (NVIDIA H100 80GB HBM3, 700.00 W).
TRAIN_GRAD_CARD_CPU = dict(grad_norm_rtol=1e-5, grad_share=1e-4)
# The DTensor path on one card over a (1, 1, 1) NCCL mesh against the
# unsharded step, DIST_STEPS steps each, bit-equal (a one-device mesh
# moves nothing, and each rank runs the unsharded step's operations):
# Qwen3-0.6B at full width, 8 x 512 (bf16, remat), then the reduced
# configs of DIST_FAMILIES in float32 compute, DIST_FAMILY_B x
# DIST_FAMILY_S (two SSD chunks); the phase within DIST_BUDGET_S.
DIST_STEPS = 3
DIST_FAMILIES = ("phi3_5_moe_42b", "mamba2_1_3b", "jamba_v0_1_52b",
                 "llama_3_2_vision_90b", "hubert_xlarge")
DIST_FAMILY_B, DIST_FAMILY_S = 4, 128
DIST_BUDGET_S = 45.0
# The serving path over a (1, 1, 1) NCCL mesh (`dist_serve_one_card`):
# Qwen3-0.6B at full width in float32, prefill SERVE_MESH_B x
# SERVE_MESH_S, then SERVE_MESH_STEPS greedy decode steps, against the
# unsharded model: the prefill's and each decode step's logits within
# SERVE_MESH_SHARE of the largest magnitude (the bound of
# tests/test_torch_dist_serve.py: the mesh's decode attention merges
# its blocks by log-sum-exp), the picks equal; within SERVE_MESH_BUDGET_S.
SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_STEPS = 4, 1024, 8
SERVE_MESH_SHARE = 1e-5
SERVE_MESH_BUDGET_S = 45.0
# Teacher-forced decode against prefill at full width, float32 compute:
# logits and K/V stacks within this (rtol and atol).
DECODE_TOL_F32 = 1e-3

# The other families' serving paths (ROADMAP queue 1 item 8), each at
# its config's full width: prefill of FAMILY_B prompts x FAMILY_S tokens
# (HuBERT: frames), then the serve loop of FAMILY_B requests, prompt
# FAMILY_PROMPT, FAMILY_GEN tokens generated.  Jamba-v0.1 (52B) and
# Llama-3.2-Vision-90B do not fit one card: each runs one period of its
# layer pattern at full width (FAMILY_DEPTH layers).
FAMILIES = ("jamba_v0_1_52b", "mamba2_1_3b", "llama_3_2_vision_90b",
            "hubert_xlarge", "phi3_5_moe_42b", "kimi_k2_1t")
FAMILY_B, FAMILY_S = 4, 4096
FAMILY_PROMPT, FAMILY_GEN = 128, 32
FAMILY_DEPTH = {"jamba_v0_1_52b": 8, "llama_3_2_vision_90b": 5}
# Mamba-2: prefill's last logits against stepping `decode_step` through
# the same MAMBA_STEP_PROMPT tokens (the chunked SSD against the exact
# recurrence), in float32 compute within DECODE_TOL_F32, and in bfloat16
# compute within MAMBA_BF16_GAP.  The two bf16 orders round apart at
# every layer, in the reference as in the port:
# `tests/torch_drift_mamba2.py` reads both packages on the same
# parameters and tokens (CPU, 2 x 512 tokens; 48 layers at width 512,
# 12 parameter seeds; 8 layers at the full width 2048, 2 seeds).  The
# reference's gap ranges 0.035-0.340, the port's is 0.50-1.64x the
# reference's on the same parameters.  The bound is twice the
# reference's largest gap, MAMBA_REF_GAP.
MAMBA_STEP_PROMPT = 512
MAMBA_REF_GAP = 0.33984375
MAMBA_BF16_GAP = 2 * MAMBA_REF_GAP
# The reduced configs of the six families in float32, card against CPU:
# prefill (2 x 128 tokens) and 3 decode steps, logits within this.
FAMILY_CARD_CPU_TOL = 1e-4

# Training of the other families on the card (ROADMAP item 8.8), each at
# its config's published widths through the port's training path
# (`make_train_step`: `LM.train_loss` with remat, the flash forward with
# its LSE and the backward kernel, the config's optimizer in place), on
# the data pipeline's batches of TRAIN_FAMILY_B x TRAIN_FAMILY_S tokens
# (HuBERT: frames and labels; the VLM: its image embeddings), seed 0,
# TRAIN_FAMILY_STEPS steps of which the first is untimed.  (arch, phase,
# layers run or None for all, the attention calls of one forward pass as
# (Sq, Sk, D, causal) and their count.)  Depth is cut where the whole
# model does not fit the card: Phi-3.5-MoE 2 of 32 layers, Gemma-7B 4 of
# 28, Llama-3.2-Vision one period, 5 of 100.  Jamba (one period: 13.27B
# f32 parameters under AdamW, about 212 GB), Kimi K2 and Nemotron-4 fit
# no single card at full width: Jamba and Kimi K2 train only in
# `lm_train_families_card_vs_cpu` at their reduced configs, Nemotron-4's
# reduced form is dense, as in `lm_train_card_vs_cpu`.
TRAIN_FAMILY_B, TRAIN_FAMILY_S = 8, 512
TRAIN_FAMILY_STEPS = 4
TRAIN_FAMILIES = (
    ("mamba2_1_3b", "lm_train_mamba2_1_3b", None, []),
    ("phi3_5_moe_42b", "lm_train_phi3_5_moe_42b", 2,
     [((512, 512, 128, True), 2)]),
    ("hubert_xlarge", "lm_train_hubert_xlarge", None,
     [((512, 512, 80, False), 48)]),
    ("gemma_7b", "lm_train_gemma_7b", 4, [((512, 512, 256, True), 4)]),
    ("llama_3_2_vision_90b", "lm_train_llama_3_2_vision_90b", 5,
     [((512, 512, 128, True), 5), ((512, 4096, 128, False), 1)]),
)
# The family whose warm step is profiled by kernel.
TRAIN_FAMILY_PROFILED = "gemma_7b"

# Fig. 10's training set (benchmarks/fig10_11_pred_accuracy.py): the
# training networks' 50 layers at published dims, 1567 // 50 = 31
# random mappings a layer, seed 0, every 5th sample held out; 300
# epochs a model, half the benchmark's 600 (`CUTS`).  Training on the
# card against the CPU: 20 epochs from the same initial weights,
# predictions within TRAIN_CARD_CPU_RTOL.
TRAIN_NETS = ("alexnet", "resnext50", "vgg16", "deepbench")
TRAIN_SAMPLES = 1567
TRAIN_EPOCHS = 300
TRAIN_CARD_CPU_RTOL = 1e-4
# Fig. 12's protocol (benchmarks/fig12_rtl_opt.py) on UNet, fused with
# population 3, its GD steps cut as the device-seeded search's are; its
# short form holds the fused engine to the host-batched one.
FIG12 = dict(steps=250, round_every=125, n_start_points=3, seed=17)
FIG12_SHORT = dict(steps=160, round_every=80, n_start_points=3, seed=17)
# Cuts from the paper's scale above.
CUTS: list = [
    "calibrated_search_unet: 250 GD steps rounded every 125, not the "
    "paper's 1490 every 500: at 500 every 250 its three searches took "
    "150-188 s of the script's 1200, and on an H100 host that "
    "dispatched 25-60% slower the whole script took 1191-1300 s",
    "calibration_train: 300 epochs a model, not the benchmark's 600: "
    "its two models took 78.8 s of a 1103 s run on such a host"]

# The co-search service slice.  Device seeding: ResNet-50's dims on
# Gemmini, 1024 members.  The device-seeded search: 256 CoSA-seeded
# starts in one chunk, 250 GD steps rounded every 125 (the paper runs
# 1490, every 500: cut to fit the script's time budget).  The fleet:
# ResNet-50 over the three shipped specs, 2 starts each, the same
# schedule.  The service: 8 requests over HTTP on the small config
# (20 steps, round every 10) and one ResNet-50 request of 250 steps.
SEED_N = 1024
DEVICE_SEEDED = dict(steps=250, round_every=125, n_start_points=256,
                     seed=0, start_points="cosa-device")
DEVICE_SEEDED_CUT = ("250 GD steps rounded every 125, not the paper's "
                     "1490 every 500: the script's time budget")
FLEET = dict(steps=250, round_every=125, n_start_points=2, seed=0)
SMALL = dict(steps=20, round_every=10)
SERVE_RESNET50 = dict(steps=250, round_every=125, n_start_points=2, seed=0)
# Population sharding (`pop_shards`): the ResNet-50 device-seeded fused
# search at P=256 over repeated cuda:0 (and every card where there are
# several), at each of POP_SHARD_COUNTS; one chunk's read-back at
# POP_READBACK statics against one shard's.
POP_SHARDS = dict(steps=50, round_every=50, n_start_points=256, seed=0,
                  start_points="cosa-device")
POP_SHARDS_CUT = ("50 GD steps rounded once, not 100 rounded every 50: "
                  "at 100 the phase took 98 s of its 60 (512 host oracle "
                  "evaluations a search, and one card's host dispatching "
                  "every shard's ops)")
POP_SHARD_COUNTS = (1, 2, 4)
POP_READBACK = dict(n_full=2, rem=0, seg_len=5)
# The chaos schedule's seed: 2 transient faults and 2 torn checkpoints.
CHAOS_SEED = 8

# The dry-run (`launch.cells`) in `dryrun_cells`: cells counted on the
# meta device on the 16x16 mesh (every shape of Qwen3-0.6B, the 1T and
# 340B training cells, the sub-quadratic long-context cells and two of
# the reference's skips; the full sweep stays with `python -m
# repro_torch.launch.dryrun --all`), the reference's skip reasons
# (`repro.configs.base.shape_applicable`), and the phase's budget.
DRYRUN_CELLS = [("qwen3_0_6b", s) for s in ("train_4k", "prefill_32k",
                                            "decode_32k", "long_500k")] + [
    ("kimi_k2_1t", "train_4k"), ("nemotron_4_340b", "train_4k"),
    ("jamba_v0_1_52b", "long_500k"), ("mamba2_1_3b", "long_500k"),
    ("gemma_7b", "long_500k"), ("hubert_xlarge", "decode_32k")]
_LONG_SKIP = "long_500k requires sub-quadratic attention"
DRYRUN_SKIPS = {("qwen3_0_6b", "long_500k"): _LONG_SKIP,
                ("gemma_7b", "long_500k"): _LONG_SKIP,
                ("hubert_xlarge", "decode_32k"):
                    "encoder-only arch has no decode step"}
DRYRUN_BUDGET_S = 90.0
DRYRUN_MESH = {"data": 16, "model": 16}
# The train cells' censuses (`CellResult.compile_s`, DTensor planning
# one step over a fake 256-rank "cuda" mesh), summed: about twice the
# 25-31 s they took on an H100 host, whose speed has moved 25-60%
# between runs.
DRYRUN_CENSUS_BUDGET_S = 60.0
# Qwen3-0.6B train_4k 16x16's census a device, GB, with NCCL's plans
# when the loss gathered the float32 logits whole (39.82 GB of it that
# all-gather); the loss on the vocabulary shards must take at least
# QWEN3_TRAIN_CUT_GB off it.
QWEN3_TRAIN_GATHERED_GB = 98.47
QWEN3_TRAIN_CUT_GB = 30.0
# The same census, and Qwen3-0.6B prefill_32k's, GB a device, when the
# residual stream lay whole over "model" between products (row-parallel
# partial sums all-reduced, Ulysses' attention output gathered whole);
# the stream sharded by sequence must take QWEN3_TRAIN_SEQ_CUT_GB off
# the train census, and the prefill census must fall below its own.
QWEN3_TRAIN_WHOLE_STREAM_GB = 58.61
QWEN3_TRAIN_SEQ_CUT_GB = 10.0
QWEN3_PREFILL_WHOLE_STREAM_GB = 31.34
# `dryrun_vs_card`: the one-device mesh on which the meta count is held
# against real steps, and the family whose training model it reuses.
ONE_DEVICE = {"data": 1, "model": 1}
DRYRUN_CARD_FAMILY = "gemma_7b"
DRYRUN_CARD_STEPS = 4
# Qwen3-0.6B serving before the flash kernels became custom ops (PERF.md
# section 5; H100 80GB HBM3, 700 W): the serve loop's tok/s and a decode
# step's wall ms.
SERVE_BEFORE = {"tok_per_s": {"PR 19 run 2": 122.0, "PR 20 run 1": 101.0},
                "decode_step_wall_ms": {"PR 19 run 2": 39.8}}
# The reference service's metric families (`repro.serve.cosearch_service`,
# `repro.obs.telemetry`, `repro.runtime.search_checkpoint`) and its
# request-lifecycle span and event names.
REF_METRIC_FAMILIES = (
    "serve_requests_submitted_total", "serve_requests_completed_total",
    "serve_segments_total", "serve_batches_total", "serve_dedup_hits_total",
    "serve_quarantined_total", "serve_batch_splits_total",
    "serve_timeouts_total", "serve_degraded_requests_total",
    "serve_retries_total", "serve_backoff_seconds_total",
    "serve_fault_events_total", "serve_request_seconds",
    "engine_cache_hit_rate", "engine_cache_size",
    "engine_cache_build_seconds_total", "engine_build_total",
    "engine_build_seconds", "checkpoint_ops_total",
    "checkpoint_bytes_total", "checkpoint_seconds")
REF_REQUEST_SPANS = ("request", "queue_wait", "segment")
REF_REQUEST_EVENTS = ("submitted", "batch_join", "drain")


def emit(obj) -> None:
    # default=float: the DNN-only model's predicted EDP is a numpy
    # float32, as in the reference.  A phase's line carries the script's
    # seconds so far (`t_s`): where its time goes.
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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


def profile_steps(torch, search, engine, lr, theta, orders,
                  n_steps: int) -> dict:
    """Where a GD step's time goes: `n_steps` Adam steps of the fused
    engine timed on the host clock, then the same under torch.profiler
    — device operations per step, device busy time per step, and the
    busy share of an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    search._adam_segment(engine.grad_fn, lr, theta, orders, 2)  # warm
    torch.cuda.synchronize()
    t0 = now()
    search._adam_segment(engine.grad_fn, lr, theta, orders, n_steps)
    torch.cuda.synchronize()
    step_ms = (now() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        search._adam_segment(engine.grad_fn, lr, theta, orders, n_steps)
        torch.cuda.synchronize()
        prof_ms = (now() - t0) * 1e3 / n_steps
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n_steps
    return {"wall_ms_per_step": step_ms,
            "wall_ms_per_step_profiled": prof_ms,
            "device_ops_per_step": len(dev) / n_steps,
            "device_busy_ms_per_step": busy_ms if dev else "not measured",
            "device_busy_share": busy_ms / step_ms if dev
            else "not measured"}


def phase_profile_gd(torch, search, wl, cfg, n_steps: int = 10,
                     phase: str = "profile_gd_steps") -> dict:
    """`profile_steps` on the host-seeded population of (wl, cfg)."""
    engine, theta, orders, _ = chunk_inputs(search, wl, cfg)
    rec = {"phase": phase, "workload": wl.name, "steps": n_steps,
           **profile_steps(torch, search, engine, cfg.lr, theta, orders,
                           n_steps)}
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


def tiny_workload(problem):
    """The port tests' 3-layer workload: the small config's."""
    Layer, Workload = problem.Layer, problem.Workload
    return Workload(layers=(
        Layer.conv(64, 64, 3, 56, name="c1"),
        Layer.matmul(512, 1024, 768, name="m1"),
        Layer.conv(128, 256, 3, 28, stride=2, name="c2"),
    ), name="tiny")


def phase_card_vs_cpu(search, problem):
    """The end-to-end test's short config on the card and on the CPU:
    rounded candidates and results must be equal."""
    import numpy as np

    wl = tiny_workload(problem)
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


def phase_device_seed(torch, np, mapping, dnn_zoo):
    """Device seeding at ResNet-50's dims, SEED_N members, both modes:
    the same uniforms (drawn on the CPU, then copied) seed on the card
    under set_sync_debug_mode("error") and on the CPU; f, theta and
    orders must be equal, and equal to the host twin."""
    wl = dnn_zoo.resnet50()
    dims = wl.dims_array()
    u_cpu = mapping.seed_uniforms(dims, SEED_N,
                                  torch.Generator().manual_seed(5))
    u_card = tuple(u.to("cuda") for u in u_cpu)
    out = {}
    for mode in ("random", "cosa"):
        def seed(dev, u):
            return mapping.seed_population(dims, SEED_N, mode=mode,
                                           device=dev, uniforms=u)
        seed("cuda", u_card)          # builds the tables on the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card = seed("cuda", u_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms = cuda_ms(lambda: seed("cuda", u_card), warmup=2, iters=10)
        cpu = seed("cpu", u_cpu)
        f_h, o_h = mapping.seed_population_host(
            dims, *(u.numpy() for u in u_cpu), mode=mode)
        for name, a, b in zip(("f", "theta", "orders"), card, cpu):
            check(torch.equal(a.cpu(), b),
                  f"device_seed {mode}: {name} card != CPU")
        check(np.array_equal(cpu[0].numpy(), f_h)
              and np.array_equal(cpu[2].numpy(), o_h),
              f"device_seed {mode}: port != host twin")
        out[mode] = {"ms_per_call": ms, "sync_free": True,
                     "equal_cpu_and_host_twin": True}
    emit({"phase": "device_seed", "workload": wl.name,
          "layers": len(wl.layers), "members": SEED_N, "spec": "gemmini",
          **out})


def phase_device_seeded_search(torch, search, mapping, oracle, wl,
                               host_res, gd_p7):
    """The fused engine seeding its 256 starts on the card
    (start_points="cosa-device") on ResNet-50, one chunk; oracle
    re-evaluation equals best_edp; GD steps profiled at P=256 beside
    the P=7 steps of the paper-protocol search."""
    cfg = search.SearchConfig(**DEVICE_SEEDED)
    pop = cfg.n_start_points
    torch.cuda.synchronize()
    t0 = now()
    res = search.dosa_search(wl, cfg, population=pop, device="cuda")
    secs = now() - t0
    edp, _ = oracle.evaluate_workload(res.best_mappings, wl.layers)
    check(edp == res.best_edp, f"device-seeded search: oracle {edp} != "
          f"best_edp {res.best_edp}")
    n_seg = len(search._segment_lengths(cfg.steps, cfg.round_every))
    check(res.n_evals == pop * (cfg.steps + n_seg) and not res.start_edps,
          f"device-seeded search: n_evals {res.n_evals}")
    engine = search.make_fused_runner(wl, cfg, "cuda")
    _, theta, orders = mapping.seed_population(
        wl.dims_array(), pop, search.chunk_generator(cfg.seed, 0, "cuda"),
        spec=engine.cspec, pe_cap=engine.pe_cap, mode="cosa",
        device="cuda")
    prof = profile_steps(torch, search, engine, cfg.lr, theta, orders, 10)
    emit({"phase": "device_seeded_search_resnet50", "cut": DEVICE_SEEDED_CUT,
          "steps": cfg.steps, "round_every": cfg.round_every,
          "population": pop, "start_points": cfg.start_points,
          "seconds": secs, "best_edp": res.best_edp, "oracle_edp": edp,
          "n_evals": res.n_evals,
          "host_cosa_p7_best_edp": host_res.best_edp,
          "ratio_to_host_cosa_p7": res.best_edp / host_res.best_edp,
          "p256_step": prof,
          "p7_step": {k: gd_p7[k] for k in prof}})


def _fleet_group_seconds(spans, t_begin):
    """Seconds of each structural group of one fleet run, from its
    spans: from the end of the previous group's last oracle span (or
    the run's start) to the end of this group's (start points, engine
    build, device work, read-back and oracle replay)."""
    groups, last_end, cur = [], t_begin, None
    for sp in spans:
        if sp.name == "fleet.fused_dispatch":
            cur = {"specs": sp.attrs["specs"],
                   "members": sp.attrs["members"], "t0": last_end}
            groups.append(cur)
        elif sp.name == "fleet.oracle" and cur is not None:
            last_end = sp.t_end
            cur["seconds"] = sp.t_end - cur["t0"]
    for g in groups:
        g.pop("t0")
    return groups


def phase_fleet(torch, fleet, search, oracle, archspec, obs, wl, problem):
    """Fleet search of ResNet-50 over the three shipped specs on the
    card: 2 engine groups, every entry re-evaluated by its spec's
    oracle, a frontier; then, on the small config, fleet equals
    single-target search per spec on the card."""
    import dataclasses

    specs = [archspec.GEMMINI_SPEC, archspec.TPU_V5E_SPEC,
             archspec.EDGE_SPEC]
    cfg = search.SearchConfig(**FLEET)
    fleet._FLEET_ENGINE_CACHE.clear()
    tracer = obs.Tracer()
    prev = obs.set_tracer(tracer)
    try:
        torch.cuda.synchronize()
        t_begin = obs.default_clock()
        t0 = now()
        res = fleet.fleet_search(wl, specs, cfg, device="cuda")
        secs = now() - t0
    finally:
        obs.set_tracer(prev)
    n_groups = len(fleet._FLEET_ENGINE_CACHE)
    check(n_groups == 2, f"fleet: {n_groups} engine groups, expected 2")
    entries = {}
    for spec in specs:
        e = res.entry(spec.name, wl.name)
        edp, _ = oracle.evaluate_workload(e.best_mappings, wl.layers,
                                          spec=spec)
        check(edp == e.best_edp, f"fleet {spec.name}: oracle {edp} != "
              f"best_edp {e.best_edp}")
        entries[spec.name] = {"best_edp": e.best_edp, "n_evals": e.n_evals,
                              "energy_pj": e.best_energy,
                              "latency_cycles": e.best_latency}
    front = res.frontier()
    check(len(front) >= 1, "fleet: empty frontier")
    small = tiny_workload(problem)
    cfg_s = search.SearchConfig(n_start_points=2, seed=3, **SMALL)
    fr = fleet.fleet_search(small, specs, cfg_s, device="cuda")
    for spec in specs:
        solo = search.dosa_search(small, dataclasses.replace(cfg_s,
                                                             spec=spec),
                                  population=2, device="cuda")
        e = fr.entry(spec.name, small.name)
        check((e.best_edp, e.n_evals, e.start_edps)
              == (solo.best_edp, solo.n_evals, solo.start_edps),
              f"fleet != single-target search on {spec.name} (small)")
    emit({"phase": "fleet_resnet50", **FLEET, "specs":
          [s.name for s in specs], "engine_groups": n_groups,
          "seconds": secs,
          "group_seconds": _fleet_group_seconds(tracer.spans(), t_begin),
          "entries": entries, "frontier": [e.spec_name for e in front],
          "small_fleet_equals_single_target": True})


def _pop_run(search, wl, cfg, device, sync) -> dict:
    """One fused search over the pop mesh `device` names, timed."""
    sync()
    t0 = now()
    res = search.dosa_search(wl, cfg, population=cfg.n_start_points,
                             device=device)
    sync()
    return {"result": (res.best_edp, res.n_evals, res.history),
            "seconds": now() - t0}


def _pop_readback(torch, search, mapping, wl, cfg, shards, devices):
    """One seeded chunk through `search.run_fused` over `shards` of
    `devices`: ((f, orders, model EDP) on the host, the best)."""
    from repro_torch.launch.mesh import make_pop_mesh
    from repro_torch.sharding.rules import member_spec

    dev = torch.device(devices[0])
    mesh = make_pop_mesh(shards, devices)
    engines = search.fused_engines(wl, cfg, mesh)
    engine = engines[mesh.devices[0]]
    _, theta, orders = mapping.seed_population(
        wl.dims_array(), cfg.n_start_points,
        search.chunk_generator(cfg.seed, 0, dev), spec=engine.cspec,
        pe_cap=engine.pe_cap, mode="cosa", device=dev)
    theta, orders = search.shard_population(theta, orders, shards, devices)
    ys, best = search.run_fused(engines, mesh, (theta, orders),
                                (member_spec(4), member_spec(2)),
                                **POP_READBACK)
    return tuple(y.cpu() for y in ys), best


def phase_pop_shards(torch, search, fleet, mapping, archspec, api,
                     service_mod, faults, problem, wl, dev="cuda:0",
                     cfg_kw=None, tiny=None):
    """Population sharding on the card: the ResNet-50 device-seeded
    fused search (P=256, 50 steps rounded once) at 1, 2 and 4 shards
    over repeated `dev`, and over every visible card when there are
    several, each oracle result equal to one shard's; one chunk's
    rounded read-back on each of those meshes bit-equal to one shard's,
    its reduced best equal to the unsharded tracker's argmin; the tiny
    fleet (TPU v5e + edge) at 2 shards equal to 1; one service request
    at shards=2 under one injected ShardLossFault, degraded to one
    shard with ("shard_fallback",) and the direct answer (the fleet and
    the service also over two distinct cards where there are several).
    `cfg_kw` and `tiny` shrink it for a rehearsal on the CPU."""
    import dataclasses

    from repro_torch.launch.mesh import auto_pop_shards

    t_phase = now()
    is_cuda = torch.device(dev).type == "cuda"
    cards = torch.cuda.device_count() if is_cuda else 0
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)
    cfg = search.SearchConfig(**(cfg_kw or POP_SHARDS))
    meshes = {f"{k}x{dev}": [dev] * k for k in POP_SHARD_COUNTS}
    pairs = {f"2x{dev}": [dev, dev]}
    if cards > 1:
        meshes["every_card"] = [f"cuda:{i}" for i in range(cards)]
        pairs["cuda:0+cuda:1"] = ["cuda:0", "cuda:1"]
    # shards=None: each mesh's count resolves as a user's would
    shards_of = {name: auto_pop_shards(cfg.n_start_points, None, devs)
                 for name, devs in meshes.items()}
    runs = {name: _pop_run(search, wl, cfg, devs, sync)
            for name, devs in meshes.items()}
    base = runs[f"1x{dev}"]["result"]
    for name, r in runs.items():
        check(r["result"] == base, f"pop_shards: the search at {name} "
              f"({r['result'][:2]}) differs from one shard's "
              f"({base[:2]})")

    (f1, o1, e1), best1 = _pop_readback(torch, search, mapping, wl, cfg, 1,
                                        [dev])
    i = int(torch.argmin(best1.edp))
    readback = {}
    for name, devs in meshes.items():
        if shards_of[name] == 1:
            continue
        (f, o, e), best = _pop_readback(torch, search, mapping, wl, cfg,
                                        shards_of[name], devs)
        rel = float(((e.double() - e1.double()).abs()
                     / e1.double().abs()).max())
        check(torch.equal(f, f1) and torch.equal(o, o1),
              f"pop_shards: the rounded read-back at {name} differs "
              f"from one shard's (max relative model EDP {rel})")
        check(best.edp.shape == (1,)
              and torch.equal(best.edp.cpu(), best1.edp[i:i + 1].cpu())
              and torch.equal(best.f.cpu(), best1.f[i:i + 1].cpu())
              and torch.equal(best.orders.cpu(),
                              best1.orders[i:i + 1].cpu()),
              f"pop_shards: the reduced best at {name} is not the "
              "unsharded tracker's argmin")
        readback[name] = {"max_rel_model_edp_diff": rel,
                          "best_model_edp": float(best.edp[0])}

    small = tiny if tiny is not None else tiny_workload(problem)
    cfg_s = search.SearchConfig(n_start_points=2, seed=3, **SMALL)
    specs = [archspec.TPU_V5E_SPEC, archspec.EDGE_SPEC]
    fleet_runs = {}
    for name, devs in {f"1x{dev}": [dev], **pairs}.items():
        sync()
        t0 = now()
        got = fleet.search_group_results(
            small, specs, dataclasses.replace(cfg_s, shards=len(devs)),
            device=devs)
        sync()
        fleet_runs[name] = (
            [(r.best_edp, r.n_evals, r.history) for r in got], now() - t0)
    for name, (res, _) in fleet_runs.items():
        check(res == fleet_runs[f"1x{dev}"][0],
              f"pop_shards: the fleet at {name} differs from one shard")

    direct = search.dosa_search(small, cfg_s, population=2, device=dev)
    service = {}
    for name, devs in pairs.items():
        fired = []

        def lose_a_shard(task_id, seg, request_ids, fired=fired):
            if seg == 1 and not fired:
                fired.append(seg)
                raise faults.ShardLossFault("shard 1 unreachable")

        svc = service_mod.CoSearchService(service_mod.ServiceConfig(
            bucket_workloads=False))
        svc.fault_hook = lose_a_shard
        rid = svc.submit(api.SearchRequest(
            workload=small, config=dataclasses.replace(cfg_s, shards=2),
            device=devs))
        out = svc.drain()[rid]
        check(fired == [1] and out.status == "degraded"
              and out.degraded == ("shard_fallback",),
              f"pop_shards: service on {name}: {out.status} "
              f"{out.degraded}")
        check((out.best_edp, out.n_evals, out.history)
              == (direct.best_edp, direct.n_evals, direct.history),
              f"pop_shards: the degraded service answer on {name} "
              "differs from direct")
        service[name] = {"status": out.status, "degraded": out.degraded,
                         "best_edp": out.best_edp}
    emit({"phase": "pop_shards", "device": dev, "cards": cards,
          "meshes": meshes, "shards": shards_of,
          "config": dict(cfg_kw or POP_SHARDS),
          "cut": POP_SHARDS_CUT if cfg_kw is None else None,
          "readback_statics": POP_READBACK,
          "search_seconds": {n: r["seconds"] for n, r in runs.items()},
          "best_edp": base[0], "n_evals": base[1],
          "readback": readback,
          "fleet_seconds": {k: v[1] for k, v in fleet_runs.items()},
          "service": service, "seconds": now() - t_phase})


def _layers_json(wl):
    return {"name": wl.name, "layers": [
        {"dims": list(lay.dims), "wstride": lay.wstride,
         "hstride": lay.hstride, "repeat": lay.repeat, "name": lay.name}
        for lay in wl.layers]}


def _http(base, path, body=None):
    """(status, parsed body) of one GET, or one POST of JSON `body`."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            text = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        text, status = e.read().decode(), e.code
    if path == "/v1/metrics":
        return status, text
    return status, json.loads(text)


def phase_service_http(torch, search, api, service_mod, server_mod, chaos,
                       problem, wl_resnet):
    """The co-search service on the card behind its HTTP front-end: 8
    requests (3 same-spec that batch into member bucket 4, 2 mixed-spec
    through the fleet engine, 1 duplicate, 1 ResNet-50 of 250 steps,
    1 malformed).  Every ok outcome equals a direct dosa_search on the
    card; a service killed after one segment resumes from its
    checkpoint to the same outcome; a seeded chaos schedule leaves the
    healthy requests' answers unchanged; /v1/metrics and /v1/trace carry
    the reference's families and span names."""
    import dataclasses
    import shutil
    import threading

    t_phase = now()
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    small = tiny_workload(problem)
    wl_small = _layers_json(small)
    same = [{"workload": wl_small,
             "config": dict(SMALL, n_start_points=1, seed=s)}
            for s in (1, 2, 3)]
    mixed = [{"workload": wl_small,
              "config": dict(SMALL, n_start_points=2, seed=4, spec=name)}
             for name in ("tpu_v5e", "edge3")]
    resnet = {"workload": _layers_json(wl_resnet), "config": SERVE_RESNET50}
    malformed = {"workload": wl_small, "config": {"stepz": 20}}
    bodies = same + mixed + [same[0], resnet]
    srv = server_mod.CoSearchServer(service_mod.ServiceConfig(
        bucket_workloads=False, checkpoint_dir=str(ckpt / "http")),
        device="cuda")
    # The scheduler starts once the burst is in, so the 3 same-spec
    # requests form one batch (the server batches what is pending when
    # it steps).
    gate = threading.Event()
    schedule = srv._schedule
    srv._schedule = lambda: (gate.wait(), schedule())
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        subs = [_http(base, "/v1/search", b) for b in bodies]
        code_bad, bad = _http(base, "/v1/search", malformed)
        check(all(c == 202 for c, _ in subs), f"submissions: {subs}")
        check([s["deduplicated"] for _, s in subs]
              == [False] * 5 + [True, False]
              and subs[5][1]["request_id"] == subs[0][1]["request_id"],
              f"dedup: {subs}")
        check(code_bad == 400 and "serveable" in bad["error"]["message"],
              f"malformed request: {code_bad} {bad}")
        torch.cuda.synchronize()
        t0 = now()
        gate.set()
        check(srv.wait_idle(timeout=900), "service did not drain")
        wall = now() - t0
        rids = [s["request_id"] for _, s in subs]
        outs = {rid: _http(base, f"/v1/result/{rid}")[1] for rid in rids}
        _, stats = _http(base, "/v1/stats")
        _, metrics = _http(base, "/v1/metrics")
        traces = {rid: _http(base, f"/v1/trace/{rid}")[1]["trace"]
                  for rid in rids}
    finally:
        srv.stop()
    check(stats["n_batches"] == 3 and stats["n_grouped_batches"] == 1,
          f"batches: {stats['n_batches']}, grouped "
          f"{stats['n_grouped_batches']}")
    # Every ok outcome against a direct search on the card.
    directs = []
    for body in same + mixed:
        c = dict(body["config"])
        spec = c.pop("spec", None)
        cfg = search.SearchConfig(
            spec=None if spec is None else server_mod.SPEC_REGISTRY[spec],
            **c)
        directs.append((small, cfg))
    directs.append((wl_resnet, search.SearchConfig(**SERVE_RESNET50)))
    # (The fleet engine records each spec's starts as it draws them, so
    # a mixed-spec request's history interleaves differently from a
    # direct search's; its best EDP and sample count are the same.)
    for i, (rid, (wl, cfg)) in enumerate(zip(rids[:5] + rids[6:],
                                            directs)):
        out = outs[rid]
        check(out["status"] == "ok", f"request {rid}: {out['status']}")
        d = search.dosa_search(wl, cfg, population=cfg.n_start_points,
                               device="cuda")
        check(out["best_edp"] == d.best_edp and out["n_evals"] == d.n_evals
              and (i in (3, 4) or out["history"]
                   == [[e, v] for e, v in d.history]),
              f"served != direct for {rid}")
    # Kill after one segment, resume from the checkpoint.
    req = api.SearchRequest(workload=small, config=search.SearchConfig(
        steps=30, round_every=10, n_start_points=2, seed=7), device="cuda")
    svc_cfg = service_mod.ServiceConfig(bucket_workloads=False,
                                        checkpoint_dir=str(ckpt / "resume"))
    svc = service_mod.CoSearchService(svc_cfg)
    rid = svc.submit(req)
    svc.step()
    del svc
    svc = service_mod.CoSearchService(svc_cfg)
    svc.submit(req)
    resumed = svc.drain()[rid].result
    n_resumed_events = len(svc.events(rid))
    direct = search.dosa_search(small, req.config, population=2,
                                device="cuda")
    check(n_resumed_events == 2 and (resumed.best_edp, resumed.n_evals,
                                     resumed.history)
          == (direct.best_edp, direct.n_evals, direct.history),
          "kill/resume outcome != direct")
    # A seeded chaos schedule: healthy requests answer unchanged.  The
    # schedule depends only on the seed and the order of the service's
    # hook calls, not on the device: seed 8 injects 2 transient faults
    # (rollback to the checkpoint, then retry) and 2 torn checkpoints,
    # as it does on the CPU.
    svc = service_mod.CoSearchService(service_mod.ServiceConfig(
        bucket_workloads=False, checkpoint_dir=str(ckpt / "chaos"),
        max_restarts=8, backoff_base_s=0.0))
    monkey = chaos.ChaosMonkey(chaos.ChaosConfig(
        seed=CHAOS_SEED, p_transient=0.4, p_torn_checkpoint=0.5,
        max_faults=4))
    monkey.attach(svc)
    chaos_reqs = [api.SearchRequest(
        workload=small, config=search.SearchConfig(n_start_points=2,
                                                   seed=s, **SMALL),
        device="cuda") for s in (4, 5)]
    for r in chaos_reqs:
        svc.submit(r)
    chaos_outs = svc.drain()
    for r in chaos_reqs:
        d = search.dosa_search(small, r.config, population=2,
                               device="cuda")
        o = chaos_outs[r.request_id]
        check(o.status == "ok" and (o.best_edp, o.n_evals, o.history)
              == (d.best_edp, d.n_evals, d.history),
              "chaos changed a healthy request's answer")
    injected = monkey.stats()
    check(injected["transient"] >= 1,
          f"chaos injected no transient fault: {injected}")
    check(injected["torn_checkpoint"] >= 1,
          f"chaos tore no checkpoint: {injected}")
    # The reference's metric families and span names.
    families = {line.split()[2] for line in metrics.splitlines()
                if line.startswith("# TYPE ")}
    missing = [f for f in REF_METRIC_FAMILIES if f not in families]
    check(not missing, f"/v1/metrics lacks {missing}")
    for rid, tree in traces.items():
        names = {tree["name"]} | {c["name"] for c in tree["children"]}
        events = [e["name"] for e in tree["events"]]
        check(set(REF_REQUEST_SPANS) <= names
              and all(e in events for e in REF_REQUEST_EVENTS),
              f"/v1/trace/{rid}: spans {names}, events {events}")
    check("dedup_hit" in [e["name"] for e in traces[rids[0]]["events"]],
          "the duplicate left no dedup_hit event")
    shutil.rmtree(ckpt, ignore_errors=True)
    labels = ["same_seed1", "same_seed2", "same_seed3", "mixed_tpu_v5e",
              "mixed_edge3", "duplicate", "resnet50"]
    emit({"phase": "service_http", "requests": len(bodies) + 1,
          "searches": len(set(rids)), "wall_seconds": wall,
          "requests_per_s": len(bodies) / wall,
          "latency_s": {lab: traces[rid]["duration_s"]
                        for lab, rid in zip(labels, rids)},
          "batches": stats["n_batches"],
          "grouped_batches": stats["n_grouped_batches"],
          "member_bucket_same_spec": 4,
          "served_equals_direct": True, "malformed": bad["error"],
          "kill_resume_equal": True, "chaos_injected": injected,
          "chaos_equal": True, "metric_families": len(REF_METRIC_FAMILIES),
          "faults": stats["faults"], "phase_seconds": now() - t_phase})


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


def flash_close(torch, out, ref, key, what):
    """Holds a flash output to its plain version: rtol FLASH_TOL[key]
    and, for bf16, an atol of FLASH_TOL times min(1, max|ref|).
    Returns (largest error, the atol)."""
    tol = FLASH_TOL[key]
    atol = tol
    if key == "bfloat16":
        atol = tol * min(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                               atol=atol, msg=lambda m: f"{what}: {m}")
    return err, atol


def missing_tile_excess(torch, attention_ref, q, k, v, ref, atol):
    """How far the plain full-attention output without the keys of
    MISSING_TILE misses `ref` under flash_close's bf16 bound: the largest
    |dropped - ref| / (atol + rtol |ref|).  Fails unless above 1, i.e.
    unless a kernel that skipped that tile would fail the bound.
    Returns it beside the same measure under a flat atol of 2e-2."""
    lo, hi = MISSING_TILE
    keep = torch.cat([torch.arange(lo), torch.arange(hi, k.shape[2])]) \
        .to(k.device)
    dropped = plain_attention(attention_ref, q, k[:, :, keep], v[:, :, keep],
                              False, 0).float()
    r = ref.float()
    rtol = FLASH_TOL["bfloat16"]
    miss = (dropped - r).abs()
    excess = (miss / (atol + rtol * r.abs())).max().item()
    flat = (miss / (rtol + rtol * r.abs())).max().item()
    check(excess > 1.0, f"bound {atol} passes a missing key tile "
          f"{MISSING_TILE} (excess {excess}) at {tuple(q.shape)} x "
          f"{tuple(k.shape)}")
    return {"scaled": excess, "flat": flat}


def phase_flash_vs_plain(torch, attend, attention_ref, flash):
    """Every FLASH_CASES shape, f32 and bf16, on the card against the
    plain version; bf16 always on wgmma, f32 always on simt."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, excess = {}, {}
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
            err, atol = flash_close(torch, out, ref, key, "flash "
                                    f"{(b, hq, hkv, sq, sk, d, causal, off)}")
            worst[key] = max(worst.get(key, 0.0), err)
            if key == "bfloat16" and not causal and sk >= MISSING_TILE[1]:
                excess[str((b, hq, hkv, sq, sk, d))] = missing_tile_excess(
                    torch, attention_ref, q, k, v, ref, atol)
    emit({"phase": "flash_vs_plain",
          "cases_b_hq_hkv_sq_sk_d_causal_qoffset": FLASH_CASES,
          "variants": {"float32": "simt", "bfloat16": "wgmma"},
          "max_abs_err": worst, "tolerance": FLASH_TOL,
          "bf16_atol": "2e-2 * min(1, max|plain|)",
          "missing_tile_excess": excess})


def phase_flash_bwd_vs_plain(torch, fa_mod, attention_ref,
                             attention_lse_ref):
    """Every FLASH_BWD_CASES shape, f32 and bf16: dq, dk and dv of the
    differentiable entry (`attention`: the forward kernel with its LSE,
    then the backward kernel) against autograd through the plain
    version on the same inputs and output gradient, each case on its
    asserted variant (bf16 wgmma, f32 simt); the forward's LSE against
    the plain one."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, worst_lse = {}, {}
    for case in FLASH_BWD_CASES:
        b, hq, hkv, sq, sk, d, causal, off = case
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).split(".")[-1]

            def randn(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)

            q, k, v = randn(b, hq, sq, d), randn(b, hkv, sk, d), \
                randn(b, hkv, sk, d)
            do = randn(b, hq, sq, d)
            before = fa_mod.attend_backward.launches
            fwd_before = dict(fa_mod.flash_attention.launches_by_variant)
            bwd_before = dict(fa_mod.attend_backward.launches_by_variant)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa_mod.attention(*leaves, causal=causal,
                             q_offset=off).backward(do)
            torch.cuda.synchronize()
            ran_on(fa_mod.flash_attention.launches_by_variant, fwd_before,
                   fa_mod.variant(dt), f"flash bwd forward {case} {dt}")
            ran_on(fa_mod.attend_backward.launches_by_variant, bwd_before,
                   fa_mod.variant(dt), f"flash bwd {case} {dt}")
            check(fa_mod.attend_backward.launches == before + 1,
                  f"flash bwd {case} {dt}: backward launches "
                  f"{fa_mod.attend_backward.launches - before}")
            refs = [t.clone().requires_grad_() for t in (q, k, v)]
            plain_attention(attention_ref, *refs, causal,
                            off).backward(do)
            for name, got, want in zip("qkv", leaves, refs):
                err = (got.grad.float() - want.grad.float()).abs().max()
                scale = want.grad.float().abs().max()
                rel = (err / scale).item()
                check(rel <= FLASH_BWD_TOL[key],
                      f"flash bwd {case} {dt} d{name}: max err {err.item()}"
                      f" = {rel} of max |plain| {scale.item()}")
                worst[key] = max(worst.get(key, 0.0), rel)
            _, lse = fa_mod.attend(q, k, v, causal=causal, q_offset=off,
                                   return_lse=True)
            _, lse_ref = attention_lse_ref(q, k, v, causal=causal,
                                           q_offset=off)
            err = (lse - lse_ref).abs().max().item()
            check(err <= FLASH_LSE_TOL,
                  f"flash LSE {case} {dt}: max abs err {err}")
            worst_lse[key] = max(worst_lse.get(key, 0.0), err)
    emit({"phase": "flash_bwd_vs_plain",
          "cases_b_hq_hkv_sq_sk_d_causal_qoffset": FLASH_BWD_CASES,
          "variants": {"float32": "simt", "bfloat16": "wgmma"},
          "max_err_share_of_max_abs_grad": worst,
          "tolerance_share": FLASH_BWD_TOL, "lse_max_abs_err": worst_lse,
          "lse_tolerance": FLASH_LSE_TOL})


def _flash_bwd_time(torch, fa_mod, attention_bwd_ref, shape, seed,
                    causal=True):
    """The backward kernel at one shape (b, hq, hkv, s, d), bf16,
    causal or full: held against the plain backward, timed beside it
    and beside SDPA's backward (autograd of
    `scaled_dot_product_attention` with `enable_gqa`, backward only);
    its bound.  Returns the numbers and the variant the kernel ran on."""
    import torch.nn.functional as F

    b, hq, hkv, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(b, hq, s, d), randn(b, hkv, s, d), \
        randn(b, hkv, s, d), randn(b, hq, s, d)
    o, lse = fa_mod.attend(q, k, v, causal=causal, return_lse=True)
    args = (q, k, v, o, do, lse)
    before = dict(fa_mod.attend_backward.launches_by_variant)
    got = fa_mod.attend_backward(*args, causal=causal)
    ran = [var for var, n in fa_mod.attend_backward.launches_by_variant
           .items() if n != before[var]]
    check(len(ran) == 1, f"flash bwd timing {shape}: launches {ran}")
    want = attention_bwd_ref(*args, causal=causal)
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    shares = [e / w.float().abs().max().item() for e, w in zip(errs, want)]
    check(max(shares) <= FLASH_BWD_TOL["bfloat16"],
          f"flash bwd timing shape {shape}: errors {errs}, shares {shares}")
    del got, want
    small = s <= 1024    # short calls: 10 back-to-back per timed run
    ms = cuda_ms(lambda: fa_mod.attend_backward(*args, causal=causal),
                 warmup=3, iters=20 if small else 10, reps=10 if small else 1)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(*args, causal=causal),
                       warmup=1, iters=10 if small else 3)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                         enable_gqa=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do, retain_graph=True), iters=10,
        reps=10 if small else 1)
    del out, ql, kl, vl
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    flops = 2.5 * 4.0 * d * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 2 * lse.numel() * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ran[0], {
        "shape_b_hq_hkv_s_d": list(shape), "causal": causal, "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
        "tflops": flops / (ms * 1e-3) / 1e12,
        "tc_share": flops / (ms * 1e-3) / PEAK_BF16_FLOPS,
        "max_abs_err": max(errs), "max_err_share": max(shares)}


def phase_flash_bwd_timing(torch, fa_mod, attention_bwd_ref, launches):
    """The backward kernel at PERF.md's flash shape (q (4, 16, 4096,
    128), k, v (4, 8, 4096, 128)) and at the training shape of
    Qwen3-0.6B (q (8, 16, 512, 128)), bf16, causal, then at the
    forward's other timed head dims (FLASH_TIMING_SHAPES: HuBERT's 80,
    full; Gemma's 256, causal), each beside its bound, the plain
    backward and SDPA's backward.  The kernel row is the flash shape's,
    with the others' numbers beside it."""
    var, flash = _flash_bwd_time(torch, fa_mod, attention_bwd_ref,
                                 (PREFILL_B, 16, 8, PREFILL_S, 128), 5)
    train_var, train = _flash_bwd_time(torch, fa_mod, attention_bwd_ref,
                                       (8, 16, 8, 512, 128), 6)
    others = [_flash_bwd_time(torch, fa_mod, attention_bwd_ref, shape,
                              seed, causal)
              for shape, causal, seed in FLASH_TIMING_SHAPES]
    variants = {var, train_var} | {v for v, _ in others}
    check(variants == {fa_mod.variant(torch.bfloat16)},
          f"flash bwd timing ran on {variants}")
    keys = ("shape_b_hq_hkv_s_d", "causal", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")
    row = {"name": "flash_attention_bwd", "variant": var,
           "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers.py:74",
           "replaces_note": "no Pallas backward: the reference "
                            "differentiates this jnp flash loop",
           "head_dims": list(fa_mod.HEAD_DIMS),
           "launches": launches, "max_abs_err": flash["max_abs_err"],
           "ms": flash["ms"], "plain_ms": flash["plain_ms"],
           "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
           "library_ms": flash["library_ms"], "held_against_plain": True,
           "at_train_shape": {key: train[key] for key in keys},
           "other_head_dims": [{key: o[key] for key in keys}
                               for _, o in others]}
    emit({"phase": "flash_bwd_timing", "dtype": "bfloat16",
          "library": "scaled_dot_product_attention(enable_gqa=True) "
                     "backward", "flash_shape": flash, "train_shape": train,
          "other_shapes": [o for _, o in others], **row})
    return row


def phase_lm_prefill(torch, lm_mod, configs, flash):
    """The LM main path: Qwen3-0.6B at full width, initialised on the
    card from seed 0, `prefill` of 4 prompts x 4096 tokens — a cold
    call, then PREFILL_WARM warm ones (their median is the warm time),
    the flash launches counted in each.  Each call's host time to
    enqueue its work is read too: where it nears the call's wall time,
    host dispatch bounds the call."""
    cfg = configs.get_config("qwen3_0_6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = lm_mod.build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, enqueued, launches, on_wgmma = [], [], [], []
    for _ in range(1 + PREFILL_WARM):
        flash.launches = 0
        flash.launches_by_variant.update(wgmma=0, simt=0)
        t0 = now()
        logits, cache = model.prefill({"tokens": tokens})
        enqueued.append(now() - t0)
        torch.cuda.synchronize()
        secs.append(now() - t0)
        launches.append(flash.launches)
        on_wgmma.append(flash.launches_by_variant["wgmma"])
    check(launches == [cfg.n_layers] * len(secs) and on_wgmma == launches,
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
    warm = sorted(secs[1:])[PREFILL_WARM // 2]
    emit({"phase": "lm_prefill_qwen3_0_6b", "batch": PREFILL_B,
          "prompt_len": PREFILL_S, "compute_dtype": cfg.compute_dtype,
          "seconds_cold": secs[0], "seconds_warm": warm,
          "seconds_warm_each": secs[1:],
          "seconds_enqueued_each": enqueued,
          "tokens_per_s_warm": tokens_n / warm,
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
          "tok_per_s_before_custom_ops": SERVE_BEFORE["tok_per_s"],
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
          "wall_ms_per_step_before_custom_ops":
              SERVE_BEFORE["decode_step_wall_ms"],
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


def _train_hook(torch, fa_mod, fault_step=None):
    """A `fault_hook` for `train_with_recovery` that records, at the
    start of every attempt, (step, clock, forward and backward flash
    launches so far) after a device sync, and raises a RuntimeError
    once at `fault_step`."""
    marks, fired = [], []

    def hook(step):
        torch.cuda.synchronize()
        marks.append((step, now(), fa_mod.flash_attention.launches,
                      fa_mod.attend_backward.launches))
        if step == fault_step and not fired:
            fired.append(step)
            raise RuntimeError("chip_smoke: injected node failure")

    return hook, marks, fired


def _per_attempt(torch, fa_mod, marks):
    """[(step, seconds, forward launches, backward launches)] of every
    attempt, from consecutive marks (the last one to now)."""
    torch.cuda.synchronize()
    end = (None, now(), fa_mod.flash_attention.launches,
           fa_mod.attend_backward.launches)
    return [(a[0], b[1] - a[1], b[2] - a[2], b[3] - a[3])
            for a, b in zip(marks, marks[1:] + [end])]


def phase_lm_train(torch, train_mod, fa_mod, configs):
    """The training path at full width: `launch.train.run` with its
    defaults on the card for TRAIN_STEPS steps, a checkpoint every
    TRAIN_CKPT_EVERY and an injected RuntimeError at TRAIN_FAULT_STEP
    (rolled back to the last checkpoint and retried); then the same
    steps uninterrupted, timed.  Gates: finite losses, one restart,
    the steps after the rollback equal to the uninterrupted run's, and
    every step launching 2 forward flash kernels a layer (remat runs
    each period again in the backward pass) and 1 backward kernel, every
    backward on the wgmma variant (bf16 compute).  Returns (backward
    launches, the trained model, the checkpoint directory, which holds
    the uninterrupted run's last checkpoint)."""
    import shutil

    cfg = configs.get_config("qwen3_0_6b")
    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--steps", str(TRAIN_STEPS), "--device", "cuda", "--seed", "0"]
    args = train_mod.parse_args(argv + [
        "--ckpt-every", str(TRAIN_CKPT_EVERY), "--ckpt-dir",
        str(ckpt / "faulty")])
    defaults = train_mod.parse_args([])
    bwd_before = dict(fa_mod.attend_backward.launches_by_variant)
    hook, marks, fired = _train_hook(torch, fa_mod, TRAIN_FAULT_STEP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    model, faulty = train_mod.run(args, fault_hook=hook, log=lambda m: None)
    faulty_s = now() - t0
    attempts = _per_attempt(torch, fa_mod, marks)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()

    clean_args = train_mod.parse_args(argv + [
        "--ckpt-every", str(TRAIN_STEPS), "--ckpt-dir",
        str(ckpt / "clean")])
    hook, clean_marks, _ = _train_hook(torch, fa_mod)
    model, clean = train_mod.run(clean_args, fault_hook=hook,
                                 log=lambda m: None)
    clean_attempts = _per_attempt(torch, fa_mod, clean_marks)
    # The uninterrupted run's last checkpoint stays for lm_serve_ckpt.
    shutil.rmtree(ckpt / "faulty", ignore_errors=True)

    losses = faulty.losses + clean.losses
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"non-finite training losses {losses}")
    check(fired == [TRAIN_FAULT_STEP] and faulty.restarts == 1
          and faulty.steps_run == TRAIN_STEPS
          and clean.restarts == 0 and len(clean.losses) == TRAIN_STEPS,
          f"restarts {faulty.restarts}, steps {faulty.steps_run}, "
          f"clean {clean.restarts} / {len(clean.losses)}")
    # Steps 0..3 ran, step 4 failed, the rollback went to step 3.
    rollback = TRAIN_FAULT_STEP - TRAIN_FAULT_STEP % TRAIN_CKPT_EVERY
    after = faulty.losses[TRAIN_FAULT_STEP:]
    check(len(after) == TRAIN_STEPS - rollback,
          f"{len(after)} steps after the rollback, losses {faulty.losses}")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(faulty.losses[:TRAIN_FAULT_STEP] + after,
               clean.losses[:TRAIN_FAULT_STEP] + clean.losses[rollback:])]
    check(max(rel) <= TRAIN_ROLLBACK_RTOL,
          f"losses after the rollback {after} != uninterrupted "
          f"{clean.losses[rollback:]} (rel {rel})")
    ran = [a for a in attempts + clean_attempts if a[2] or a[3]]
    check(len(ran) == len(faulty.losses) + len(clean.losses)
          and all((f, b) == (2 * cfg.n_layers, cfg.n_layers)
                  for _, _, f, b in ran),
          f"flash launches per step (step, s, forward, backward): "
          f"{attempts + clean_attempts}")
    bwd_by_variant = {var: n - bwd_before[var] for var, n in
                      fa_mod.attend_backward.launches_by_variant.items()}
    expected = fa_mod.variant(torch.bfloat16)
    check(bwd_by_variant == {var: sum(a[3] for a in ran) * (var == expected)
                             for var in bwd_by_variant},
          f"training's backward launches by variant {bwd_by_variant}, "
          f"expected all on {expected}")
    # Steps 1-4: step 0 includes first-call set-up, step 5 the save.
    step_s = statistics.median(a[1] for a in clean_attempts[1:-1])
    tokens = defaults.batch * defaults.seq
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    layer_mm = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d \
        + 3 * d * cfg.d_ff
    mm_params = cfg.n_layers * layer_mm + d * cfg.vocab_size
    s = defaults.seq
    attn_fwd = cfg.n_layers * 4.0 * hd * defaults.batch * hq * s * (s + 1) / 2
    flops = 6.0 * mm_params * tokens + 3.5 * attn_fwd
    emit({"phase": "lm_train_qwen3_0_6b", "argv": argv,
          "defaults": {"batch": defaults.batch, "seq": defaults.seq,
                       "lr": defaults.lr, "microbatches":
                           defaults.microbatches},
          "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
          "optimizer": cfg.optimizer, "remat": cfg.remat,
          "params": n_params, "matmul_params": mm_params,
          "ckpt_every": TRAIN_CKPT_EVERY, "fault_step": TRAIN_FAULT_STEP,
          "losses_with_fault": faulty.losses,
          "losses_uninterrupted": clean.losses,
          "rollback_max_rel_diff": max(rel),
          "rollback_rtol": TRAIN_ROLLBACK_RTOL,
          "restarts": faulty.restarts,
          "stragglers": faulty.straggler_steps + clean.straggler_steps,
          "attempts_step_s_fwd_bwd": attempts,
          "uninterrupted_step_s_fwd_bwd": clean_attempts,
          "flash_fwd_launches_per_step": 2 * cfg.n_layers,
          "flash_bwd_launches_per_step": cfg.n_layers,
          "flash_bwd_launches_by_variant": bwd_by_variant,
          "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "step_flops": flops, "step_flops_matmul_6nt":
              6.0 * mm_params * tokens,
          "bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
          "bound_share": flops / PEAK_BF16_FLOPS / step_s,
          "run_with_fault_seconds": faulty_s,
          "max_memory_allocated_bytes": peak})
    return sum(a[3] for a in ran), model, ckpt


def profile_step(torch, step_fn, params, opt, batch, top: int = 14):
    """Where one warm training step's device time goes: one `step_fn`
    call (after a warm one) under torch.profiler; device time in the
    flash forward and backward kernels, in cuBLAS matrix products and in
    the rest (the flash backward also by its kernels: Delta, dK/dV, dQ),
    and the `top` kernels by device time.  Returns the numbers and the
    state after the two steps."""
    from torch.profiler import ProfilerActivity, profile

    params, opt, _ = step_fn(params, opt, batch)            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = now()
        params, opt, met = step_fn(params, opt, batch)
        float(met["loss"])
        wall_ms = (now() - t0) * 1e3
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    fwd = sum(t for n, t in by_name.items() if "flash_fwd" in n)
    bwd_parts = {part: sum(t for n, t in by_name.items() if part in n)
                 for part in ("bwd_delta", "bwd_dkdv", "bwd_dq")}
    bwd = sum(bwd_parts.values())
    gemm = sum(t for n, t in by_name.items()
               if any(w in n for w in ("gemm", "nvjet", "xmma", "cutlass")))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms_profiled": wall_ms, "device_ops": n_ops,
            "device_busy_ms": busy if n_ops else "not measured",
            "device_idle_share": 1.0 - busy / wall_ms if n_ops else None,
            "flash_fwd_ms": fwd, "flash_bwd_ms": bwd,
            "flash_bwd_ms_by_kernel": bwd_parts, "cublas_gemm_ms": gemm,
            "other_ms": busy - fwd - bwd - gemm,
            "top_kernels_ms": {n[:100]: t for n, t in ranked}}, params, opt


def phase_profile_train_step(torch, model, train_step_mod, optimizer,
                             pipeline):
    """`profile_step` of `launch.train`'s configuration on the trained
    Qwen3-0.6B (a fresh AdamW state), batch 8 x 512."""
    tcfg = train_step_mod.TrainConfig(
        opt=optimizer.OptConfig(lr=3e-4, warmup_steps=20))
    step_fn, _ = train_step_mod.make_train_step(model, tcfg)
    params, opt = train_step_mod.init_train_state(model, tcfg)
    data = pipeline.DataConfig(seed=0, vocab_size=model.cfg.vocab_size,
                               seq_len=512, global_batch=8)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in pipeline.make_batch(data, 0).items()}
    prof, _, opt = profile_step(torch, step_fn, params, opt, batch)
    del opt
    emit({"phase": "profile_train_step", "batch": 8, "seq": 512, **prof})


def phase_lm_train_card_vs_cpu(torch, lm_mod, configs, train_step_mod,
                               optimizer, pipeline):
    """The reduced config in float32, the same parameters on the CPU and
    on the card, 3 steps of `make_train_step` on the same batches:
    losses and parameters within the CPU parity tolerances."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_config("qwen3_0_6b", reduced=True),
                              compute_dtype="float32")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu = lm_mod.build_model(cfg, device="cpu", generator=gen)
    card = lm_mod.build_model(
        cfg, device="cuda",
        params=lm_mod._tree_map(lambda t: t.detach().to("cuda"),
                                cpu.params))
    tcfg = train_step_mod.TrainConfig(
        opt=optimizer.OptConfig(lr=1e-3, warmup_steps=2))
    data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                               seq_len=64, global_batch=4)
    runs = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        step_fn, _ = train_step_mod.make_train_step(model, tcfg)
        params, opt = train_step_mod.init_train_state(model, tcfg)
        losses = []
        for step in range(3):
            batch = {k: torch.from_numpy(v).to(name) for k, v in
                     pipeline.make_batch(data, step).items()}
            params, opt, met = step_fn(params, opt, batch)
            losses.append(float(met["loss"]))
        runs[name] = (losses, [t.detach().cpu() for t in
                               optimizer.tree_leaves(params)])
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    check(loss_rel <= TRAIN_CARD_CPU["loss_rtol"],
          f"training losses card {lg} != cpu {lc}")
    tol = TRAIN_CARD_CPU["param_tol"]
    err = 0.0
    for a, b in zip(pg, pc):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        err = max(err, (a - b).abs().max().item())
    emit({"phase": "lm_train_card_vs_cpu",
          "config": "qwen3_0_6b reduced f32, 3 steps, 4 x 64 tokens",
          "losses_cpu": lc, "losses_cuda": lg, "loss_max_rel_diff": loss_rel,
          "param_max_abs_diff": err, "tolerances": TRAIN_CARD_CPU})


def phase_analysis_lint(an_report):
    """The port's lint over this checkout against its baseline (no new
    finding) and the shipped specs' lint (clean), on the host."""
    t0 = now()
    lint = an_report.lint_section(ROOT, an_report.DEFAULT_BASELINE)
    spec = an_report.speclint_section()
    seconds = now() - t0
    check(lint["ok"], "analysis_lint: new findings "
          + "; ".join(f"{v['path']}:{v['line']} {v['rule']}"
                      for v in lint["new"]))
    check(spec["ok"], f"analysis_lint: spec lint {spec['specs']}")
    emit({"phase": "analysis_lint", "total": lint["total"],
          "by_rule": lint["by_rule"], "baselined": lint["baselined"],
          "new": len(lint["new"]),
          "fixed": len(lint["baseline_diff"]["fixed"]),
          "spec_issues": {k: len(v) for k, v in spec["specs"].items()},
          "seconds": seconds})


def phase_analysis_contracts(torch, an_report, contracts):
    """The engine contracts on the card, every check gated; negative
    controls that must fail on the card (the guards are armed there);
    the same contracts on the CPU, fingerprints compared."""
    t0 = now()
    card = an_report.contracts_section("cuda")
    card_s = now() - t0
    failed = {k: v["detail"] for k, v in card["checks"].items()
              if isinstance(v, dict) and not v["passed"]}
    check(card["ok"] and not failed,
          f"analysis_contracts on the card: {failed}")
    controls = {}
    x = torch.ones(4096, device="cuda")
    for name, fn, op in (("item", lambda t: t.sum().item(),
                          "_local_scalar_dense"),
                         ("nonzero", lambda t: t.nonzero(), "nonzero")):
        r = contracts.transfer_free(fn, lambda: ((x.clone(),), {}))
        check(not r.passed, f"negative control {name} passed "
              f"transfer_free on the card: {r.detail}")
        check(op in r.detail and "RuntimeError" in r.detail,
              f"negative control {name}: the recorder and the sync "
              f"guard must both fire: {r.detail}")
        controls[name] = r.detail
    check(torch.cuda.get_sync_debug_mode() == 0,
          "set_sync_debug_mode left set after the contracts")
    t1 = now()
    cpu = an_report.contracts_section("cpu")
    cpu_s = now() - t1
    fp_card = card["checks"]["search.trace_fingerprint"]
    fp_cpu = cpu["checks"]["search.trace_fingerprint"]
    emit({"phase": "analysis_contracts", "device": card["device"],
          "checks": {k: v["passed"] if isinstance(v, dict) else v
                     for k, v in card["checks"].items()},
          "details": {k: v["detail"] for k, v in card["checks"].items()
                      if isinstance(v, dict)},
          "negative_controls": controls,
          "cpu_ok": cpu["ok"],
          "cpu_failed": {k: v["detail"] for k, v in cpu["checks"].items()
                         if isinstance(v, dict) and not v["passed"]},
          "fingerprint_card": fp_card, "fingerprint_cpu": fp_cpu,
          "fingerprints_equal": fp_card == fp_cpu,
          "seconds_card": card_s, "seconds_cpu": cpu_s})


def _dryrun_whole(key: str, kind: str, rows: int, seq: int,
                  width: int) -> bool:
    """Whether census key `key` ("<kind> <dtype>[dims]") is a `kind`
    of a whole (rows, seq, width) tensor: its last dim `width` and its
    size rows x seq x width (a gather stacks its shards on dim 0)."""
    m = re.fullmatch(rf"{kind} \w+\[([\d, ]+)\]", key)
    if not m:
        return False
    dims = [int(d) for d in m.group(1).split(", ")]
    return dims[-1] == width and math.prod(dims) == rows * seq * width


def phase_dryrun_cells(torch, cells, tpu_model):
    """The dry-run on the host: `run_cell` on the 16x16 mesh for
    DRYRUN_CELLS, each step traced on the meta device (nothing
    allocated or launched), each train cell's collective census over a
    fake "cuda" production mesh (NCCL's plans).  Gates: every
    applicable cell counted, every other skipped with the reference's
    reason; every counted cell's census (train, prefill and decode)
    under `parse_collective_bytes`' keys with a total above 0, each
    decode cell's total below its cache's bytes a device
    (`cells.cache_bytes`), Qwen3-0.6B's train all-to-all above 0, its
    train census free of any collective whose last dim is the whole
    vocabulary (`CollectiveCensus.by_shape`) and at least
    QWEN3_TRAIN_CUT_GB below QWEN3_TRAIN_GATHERED_GB; with the stream
    sharded by sequence, that census free of any all-reduce of the
    stream (16, 4096, 1024) and of any all-gather of the whole attention
    output (16, 4096, 2048), and at least QWEN3_TRAIN_SEQ_CUT_GB below
    QWEN3_TRAIN_WHOLE_STREAM_GB, Qwen3's prefill_32k census below
    QWEN3_PREFILL_WHOLE_STREAM_GB; the card's allocated and peak bytes
    unchanged; the counts (`lower_s`)
    within DRYRUN_BUDGET_S and the censuses (`compile_s`) within
    DRYRUN_CENSUS_BUDGET_S.  Prints per device the FLOPs, bytes,
    memory, the census and the three roofline terms on the H100 with
    their bound."""
    t0 = now()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    keys = set(cells.parse_collective_bytes(""))
    rows = []
    by_shape = {}
    for arch, shape in DRYRUN_CELLS:
        census = cells.CollectiveCensus()
        res = cells.run_cell(arch, shape, multi_pod=False, device="cuda",
                             census=census)
        by_shape[arch, shape] = census.by_shape
        skip = DRYRUN_SKIPS.get((arch, shape), "")
        check(res.ok == (not skip) and res.skip_reason == skip,
              f"dryrun {arch} {shape}: ok {res.ok}, skip "
              f"{res.skip_reason!r}, error {res.error!r}; expected "
              f"{'skip ' + repr(skip) if skip else 'a count'}")
        row = {"arch": arch, "shape": shape, "mode": res.mode,
               "ok": res.ok, "skip_reason": res.skip_reason}
        if res.ok:
            coll = res.collectives
            check(coll is not None and set(coll) == keys
                  and coll["total"] > 0,
                  f"dryrun {arch} {shape}: census {coll}")
            if res.mode == "decode":
                row["cache_bytes_per_device"] = cells.cache_bytes(
                    cells.get_config(arch), cells.SHAPES[shape],
                    DRYRUN_MESH)
                check(coll["total"] < row["cache_bytes_per_device"],
                      f"dryrun {arch} {shape}: the decode step's census "
                      f"{coll['total']:.4g} B is not below its cache's "
                      f"{row['cache_bytes_per_device']:.4g} B a device")
            terms = tpu_model.step_roofline(
                res.flops, res.bytes_accessed, coll["total"],
                target=H100_SXM)
            mem = res.memory
            row.update(
                trace_s=res.lower_s, census_s=res.compile_s,
                flops_per_device=res.flops,
                bytes_per_device=res.bytes_accessed, memory=mem,
                fits_hbm=mem["argument_size_in_bytes"]
                + mem["output_size_in_bytes"] <= H100_SXM.hbm_bytes,
                collectives=coll,
                collectives_gb={k: v / 1e9 for k, v in coll.items()
                                if k != "n_ops"},
                compute_s=terms.compute_s, memory_s=terms.memory_s,
                collective_s=terms.collective_s, bound=terms.bound,
                step_s=terms.step_s)
        rows.append(row)
    qwen = next(r for r in rows if (r["arch"], r["shape"])
                == ("qwen3_0_6b", "train_4k"))
    check(qwen["collectives"]["all-to-all"] > 0,
          f"Qwen3-0.6B train_4k: no all-to-all in NCCL's plans "
          f"{qwen['collectives']}")
    vocab = cells.get_config("qwen3_0_6b").vocab_size
    qwen["vocab_collectives"] = [
        key for key in by_shape["qwen3_0_6b", "train_4k"]
        if re.search(rf"[\[ ]{vocab}\]", key)]
    check(not qwen["vocab_collectives"],
          f"Qwen3-0.6B train_4k: collectives over the whole vocabulary "
          f"{qwen['vocab_collectives']}")
    check(qwen["collectives_gb"]["total"]
          <= QWEN3_TRAIN_GATHERED_GB - QWEN3_TRAIN_CUT_GB,
          f"Qwen3-0.6B train_4k: census {qwen['collectives_gb']['total']:.2f}"
          f" GB a device, not {QWEN3_TRAIN_CUT_GB} below the "
          f"{QWEN3_TRAIN_GATHERED_GB} of a loss that gathers the logits")
    qwen_cfg = cells.get_config("qwen3_0_6b")
    n_rows = cells.SHAPES["train_4k"].global_batch // DRYRUN_MESH["data"]
    seq = cells.SHAPES["train_4k"].seq_len
    qwen["whole_stream_collectives"] = [
        key for key in by_shape["qwen3_0_6b", "train_4k"]
        if _dryrun_whole(key, "all-reduce", n_rows, seq, qwen_cfg.d_model)
        or _dryrun_whole(key, "all-gather", n_rows, seq, qwen_cfg.q_dim)]
    check(not qwen["whole_stream_collectives"],
          f"Qwen3-0.6B train_4k: the stream all-reduced or the attention "
          f"output gathered whole {qwen['whole_stream_collectives']}")
    check(qwen["collectives_gb"]["total"]
          <= QWEN3_TRAIN_WHOLE_STREAM_GB - QWEN3_TRAIN_SEQ_CUT_GB,
          f"Qwen3-0.6B train_4k: census {qwen['collectives_gb']['total']:.2f}"
          f" GB a device, not {QWEN3_TRAIN_SEQ_CUT_GB} below the "
          f"{QWEN3_TRAIN_WHOLE_STREAM_GB} of a stream whole over 'model'")
    prefill = next(r for r in rows if (r["arch"], r["shape"])
                   == ("qwen3_0_6b", "prefill_32k"))
    check(prefill["collectives_gb"]["total"] < QWEN3_PREFILL_WHOLE_STREAM_GB,
          f"Qwen3-0.6B prefill_32k: census "
          f"{prefill['collectives_gb']['total']:.2f} GB a device, not below "
          f"the {QWEN3_PREFILL_WHOLE_STREAM_GB} of a stream whole over "
          f"'model'")
    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() == allocated
          and torch.cuda.max_memory_allocated() == allocated,
          f"the dry-run allocated on the card: {allocated} B before, "
          f"{torch.cuda.memory_allocated()} after, peak "
          f"{torch.cuda.max_memory_allocated()}")
    count_s = sum(r.get("trace_s", 0.0) for r in rows)
    census_s = sum(r.get("census_s", 0.0) for r in rows)
    check(count_s <= DRYRUN_BUDGET_S,
          f"dryrun_cells counts took {count_s:.1f} s, budget "
          f"{DRYRUN_BUDGET_S} s")
    check(census_s <= DRYRUN_CENSUS_BUDGET_S,
          f"dryrun_cells censuses took {census_s:.1f} s, budget "
          f"{DRYRUN_CENSUS_BUDGET_S} s")
    emit({"phase": "dryrun_cells", "mesh": "16x16", "devices": 256,
          "target": "H100_SXM", "census_plans": "cuda (NCCL)",
          "cells": rows, "count_s": count_s, "census_s": census_s,
          "seconds": now() - t0, "budget_s": DRYRUN_BUDGET_S,
          "census_budget_s": DRYRUN_CENSUS_BUDGET_S})


def phase_hillclimb_qwen3(hillclimb):
    """`hillclimb.run` of "baseline" and "no_remat" on Qwen3-0.6B
    train_4k, 16x16, H100 terms, the census over a fake "cuda" mesh;
    its JSON goes under build/.  Gates: the recompute removed, the
    compute term falls; each variant's collective term is above 0."""
    import os

    out = ROOT / "build" / "chip_smoke_hillclimb"
    out.mkdir(parents=True, exist_ok=True)
    prev = os.getcwd()
    t0 = now()
    os.chdir(out)
    try:
        recs = {v: hillclimb.run("qwen3_0_6b", "train_4k", v,
                                 device="cuda")
                for v in ("baseline", "no_remat")}
    finally:
        os.chdir(prev)
    check(recs["no_remat"]["compute_s"] < recs["baseline"]["compute_s"],
          f"no_remat compute {recs['no_remat']['compute_s']} s not below "
          f"baseline {recs['baseline']['compute_s']} s")
    for v, rec in recs.items():
        check(rec["collective_s"] > 0,
              f"hillclimb {v}: collective term {rec['collective_s']} s "
              f"from census {rec['coll']}")
    emit({"phase": "hillclimb_qwen3", "arch": "qwen3_0_6b",
          "shape": "train_4k", "mesh": "16x16", "target": "H100_SXM",
          "records": recs, "seconds": now() - t0,
          "file": str(out / "artifacts" / "perf"
                      / "qwen3_0_6b_train_4k.json")})


def phase_example_quickstart():
    """`examples/torch_quickstart.py` in a process of its own, on the
    card (its default): it exits 0, ran on cuda, and its printed best
    EDP equals the numpy oracle's EDP of the best mappings it
    printed."""
    import math
    import os
    import re

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    t0 = now()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    secs = now() - t0
    out = proc.stdout
    check(proc.returncode == 0, f"torch_quickstart.py exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    best = re.search(r"^best EDP: (\S+)", out, re.M)
    orc = re.search(r"^oracle EDP of the best mappings: (\S+)", out, re.M)
    check(best is not None and orc is not None and "device: cuda" in out,
          f"torch_quickstart.py printed {out[-1500:]}")
    best, orc = float(best.group(1)), float(orc.group(1))
    check(math.isfinite(best) and best == orc,
          f"quickstart best EDP {best} != oracle {orc}")
    emit({"phase": "example_torch_quickstart", "seconds": secs,
          "best_edp": best, "oracle_edp": orc, "stdout": out[-1200:]})


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples; a
    Python number counts as a 4-byte scalar, None as nothing."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if tree is None:
        return 0
    return tree.nbytes if hasattr(tree, "nbytes") else 4


def hold_meta_to_card(torch, cells, tpu_model, smi, case, cfg, shape,
                      train_overrides, run_step, card_args, measured_s,
                      extra):
    """The dry-run held against the card on a one-device mesh: (a) the
    meta count of `cfg` at `shape` (`cells.measure`, the counter
    `run_cell` uses) equals FlopCounterMode around one real step
    (`run_step`, not timed), op by op; (b) its argument bytes equal the
    card's `card_args` bytes; (c) its H100 roofline step is at most the
    measured step `measured_s`.  Prints the roofline fraction."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = now()
    meta, memory = cells.measure(cfg, shape, ONE_DEVICE, train_overrides)
    meta_s = now() - t0
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        run_step()
    torch.cuda.synchronize()
    card = cells.flops_by_op(fc)
    differ = {op: {"card": card.get(op), "meta": meta.flops_by_op.get(op)}
              for op in sorted(set(card) | set(meta.flops_by_op))
              if card.get(op) != meta.flops_by_op.get(op)}
    check(not differ and int(fc.get_total_flops()) == meta.flops,
          f"{case}: FLOPs on the card {int(fc.get_total_flops())} != meta "
          f"{meta.flops}; differing ops {differ}")
    card_bytes = tree_nbytes(card_args)
    check(card_bytes == memory["argument_size_in_bytes"],
          f"{case}: argument bytes on the card {card_bytes} != meta "
          f"{memory['argument_size_in_bytes']}")
    terms = tpu_model.step_roofline(meta.flops, meta.bytes_accessed, 0.0,
                                    target=H100_SXM)
    check(terms.step_s <= measured_s,
          f"{case}: roofline step {terms.step_s} s above the measured "
          f"{measured_s} s")
    top_bytes = sorted(meta.bytes_by_op.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "dryrun_vs_card", "case": case, "mesh": ONE_DEVICE,
          "batch": shape.global_batch, "seq": shape.seq_len,
          "mode": shape.mode, "flops_meta": meta.flops,
          "flops_card": int(fc.get_total_flops()),
          "flops_by_op": meta.flops_by_op,
          "bytes_accessed_meta": meta.bytes_accessed,
          "bytes_top_ops": dict(top_bytes), "memory_meta": memory,
          "argument_bytes_card": card_bytes,
          "compute_s": terms.compute_s, "memory_s": terms.memory_s,
          "bound": terms.bound, "roofline_step_s": terms.step_s,
          "measured_step_s": measured_s,
          "roofline_fraction": terms.step_s / measured_s,
          "meta_trace_s": meta_s, "nvidia_smi": smi, **extra})


def _launches(fa_mod) -> tuple[dict, dict]:
    return (dict(fa_mod.flash_attention.launches_by_variant),
            dict(fa_mod.attend_backward.launches_by_variant))


def _check_step_launches(fa_mod, before, calls, case, train=True,
                         variant="wgmma"):
    """One step's flash launches since `before`: per attention call 2
    forward (remat) and 1 backward in training, 1 forward in prefill,
    all on `variant`."""
    after = _launches(fa_mod)
    diff = [{v: a[v] - b[v] for v in a} for a, b in zip(after, before)]
    want = [{v: (2 if train else 1) * calls * (v == variant)
             for v in ("wgmma", "simt")},
            {v: (calls if train else 0) * (v == variant)
             for v in ("wgmma", "simt")}]
    check(diff == want, f"{case}: flash launches (forward, backward) "
          f"{diff}, expected {want}")


def phase_dryrun_vs_card_train(torch, cells, tpu_model, fa_mod, smi, case,
                               st, measured_s=None):
    """`hold_meta_to_card` for a training state `st` (model, params,
    opt, step_fn, opt_cfg, batch, calls_per_step) at 8 x 512.  Without
    `measured_s`, DRYRUN_CARD_STEPS steps are timed here (the first
    warm) and their median taken; each step's flash launches are
    gated."""
    model, calls = st["model"], st["calls_per_step"]
    shape = cells.ShapeConfig(f"{case}_shape", TRAIN_FAMILY_S,
                              TRAIN_FAMILY_B, "train")
    card_args = (st["params"], st["opt"], st["batch"])

    def run_step():
        before = _launches(fa_mod)
        st["params"], st["opt"], met = st["step_fn"](
            st["params"], st["opt"], st["batch"])
        loss = float(met["loss"])
        _check_step_launches(fa_mod, before, calls, case)
        check(loss == loss, f"{case}: loss {loss}")

    timed = []
    if measured_s is None:
        for _ in range(DRYRUN_CARD_STEPS):
            torch.cuda.synchronize()
            t0 = now()
            run_step()
            timed.append(now() - t0)
        measured_s = statistics.median(timed[1:])
    hold_meta_to_card(torch, cells, tpu_model, smi, case, model.cfg, shape,
                      {"opt": st["opt_cfg"]}, run_step, card_args,
                      measured_s, {"layers": model.cfg.n_layers,
                                   "optimizer": model.cfg.optimizer,
                                   "remat": model.cfg.remat,
                                   "steps_timed_s": timed})


def phase_dryrun_vs_card_qwen3(torch, cells, tpu_model, lm_mod, configs,
                               train_step_mod, optimizer, pipeline, fa_mod,
                               smi):
    """`dryrun_vs_card` for Qwen3-0.6B at full width: training 8 x 512
    (AdamW, remat, `launch.train`'s learning rate) and prefill 4 x 4096
    (int32 tokens, as the dry-run's batch), each model drawn on the card
    from seed 0."""
    cfg = configs.get_config("qwen3_0_6b")
    model = lm_mod.build_model(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=20)
    step_fn, init_opt = train_step_mod.make_train_step(
        model, train_step_mod.TrainConfig(opt=opt_cfg))
    data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                               seq_len=TRAIN_FAMILY_S,
                               global_batch=TRAIN_FAMILY_B)
    st = {"model": model, "params": model.params, "step_fn": step_fn,
          "opt_cfg": opt_cfg, "calls_per_step": cfg.n_layers,
          "batch": {k: torch.from_numpy(v).to("cuda")
                    for k, v in pipeline.make_batch(data, 0).items()}}
    st["opt"] = init_opt(opt_cfg, st["params"])
    phase_dryrun_vs_card_train(torch, cells, tpu_model, fa_mod, smi,
                               "qwen3_0_6b_train", st)
    del st
    torch.cuda.empty_cache()

    model = lm_mod.build_model(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(1, cfg.vocab_size,
                                     (PREFILL_B, PREFILL_S), generator=gen,
                                     device="cuda", dtype=torch.int32)}

    def run_step():
        before = _launches(fa_mod)
        logits, _ = model.prefill(batch)
        torch.cuda.synchronize()
        _check_step_launches(fa_mod, before, cfg.n_layers,
                             "qwen3_0_6b_prefill", train=False)
        return logits

    run_step()                                              # warm
    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = now()
        run_step()
        timed.append(now() - t0)
    shape = cells.ShapeConfig("qwen3_0_6b_prefill_shape", PREFILL_S,
                              PREFILL_B, "prefill")
    hold_meta_to_card(torch, cells, tpu_model, smi, "qwen3_0_6b_prefill",
                      cfg, shape, None, run_step, (model.params, batch),
                      statistics.median(timed),
                      {"layers": cfg.n_layers, "calls_timed_s": timed})
    del model
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def attention_calls(cfg) -> int:
    """Attention calls of one forward pass: a self-attention call a
    layer that has one, and a cross-attention call a cross layer."""
    return sum(int(cfg.is_attn_layer(i)) + int(cfg.is_cross_attn_layer(i))
               for i in range(cfg.n_layers))


def phase_dist_train_one_card(torch, lm_mod, configs, train_step_mod,
                              optimizer, pipeline, mesh_mod, cells, fa_mod,
                              reset):
    """`dist_train_one_card`: DIST_STEPS steps through the DTensor path
    over an NCCL world of one process (mesh (1, 1, 1)) against the
    unsharded `make_train_step` from the same seed on the same batches,
    for Qwen3-0.6B at full width (8 x 512, bf16, AdamW) and the reduced
    configs of DIST_FAMILIES (DIST_FAMILY_B x DIST_FAMILY_S, float32
    compute, each config's optimizer).  Gates: losses bit-equal to the
    unsharded step's (and the reduced configs' final parameters),
    every step's flash launches (2 forward an attention call with
    remat, 1 backward, on the variant the compute type picks), no
    collective, the phase within DIST_BUDGET_S.  `reset` sets every
    launch count to 0; it is called between the unsharded runs and the
    DTensor runs, so the counts read after the phase are the DTensor
    path's alone.  Returns the launches the path must count
    ({"wgmma": (forward, backward), "simt": (forward, backward)})."""
    import dataclasses

    t_phase = now()
    cases = [("qwen3_0_6b", configs.get_config("qwen3_0_6b"),
              TRAIN_FAMILY_B, TRAIN_FAMILY_S)]
    cases += [(arch, dataclasses.replace(
        configs.get_config(arch, reduced=True), compute_dtype="float32"),
        DIST_FAMILY_B, DIST_FAMILY_S) for arch in DIST_FAMILIES]
    opt_cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=20)
    tcfg = train_step_mod.TrainConfig(opt=opt_cfg)

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def run(arch, cfg, b, s, mesh):
        data = pipeline.DataConfig(
            seed=0, vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
            modality=cfg.modality, d_model=cfg.d_model,
            n_image_tokens=cfg.n_image_tokens)
        model = lm_mod.build_model(
            cfg, device="cuda", mesh=mesh,
            generator=torch.Generator(device="cuda").manual_seed(0))
        step, _ = train_step_mod.make_train_step(model, tcfg, mesh)
        params, opt = train_step_mod.init_train_state(model, tcfg, mesh)
        calls = attention_calls(cfg)
        var = "wgmma" if cfg.compute_dtype == "bfloat16" else "simt"
        losses, step_s = [], []
        census = cells.CollectiveCensus()
        for i in range(DIST_STEPS):
            batch = {k: torch.from_numpy(v).to("cuda")
                     for k, v in pipeline.make_batch(data, i).items()}
            before = _launches(fa_mod)
            torch.cuda.synchronize()
            t0 = now()
            # The census (a dispatch mode: host time on every operation)
            # on the first step only; the later ones are timed bare.
            with census if i == 0 else contextlib.nullcontext():
                params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            step_s.append(now() - t0)
            _check_step_launches(fa_mod, before, calls,
                                 f"dist_train_one_card {arch}", variant=var)
        final = None if arch == "qwen3_0_6b" else [
            whole(p).detach().clone()
            for p in optimizer.tree_leaves(params)]
        del model, params, opt
        torch.cuda.empty_cache()
        return {"losses": losses, "step_s": step_s,
                "census": census.result(), "params": final,
                "calls": calls, "variant": var}

    plain = {arch: run(arch, cfg, b, s, None) for arch, cfg, b, s in cases}
    reset()
    mesh = mesh_mod.init_train_mesh(
        (1, 1, 1), device="cuda", init_method=f"tcp://localhost:{free_port()}",
        world_size=1, rank=0)
    sharded = {}
    try:
        for arch, cfg, b, s in cases:
            torch.cuda.reset_peak_memory_stats()
            sharded[arch] = run(arch, cfg, b, s, mesh)
            sharded[arch]["peak"] = torch.cuda.max_memory_allocated()
        mesh_dims = list(mesh.mesh_dim_names)
    finally:
        mesh_mod.close_train_mesh()
    want = {"wgmma": [0, 0], "simt": [0, 0]}
    for arch, cfg, b, s in cases:
        got, ref = sharded[arch], plain[arch]
        check(all(x == x and abs(x) < float("inf") for x in got["losses"]),
              f"dist_train_one_card {arch}: non-finite losses "
              f"{got['losses']}")
        check(got["losses"] == ref["losses"],
              f"dist_train_one_card {arch}: losses {got['losses']} "
              f"against the unsharded step's {ref['losses']}")
        params_equal = None
        if ref["params"] is not None:
            params_equal = all(torch.equal(x, y) for x, y in
                               zip(got["params"], ref["params"]))
            check(params_equal, f"dist_train_one_card {arch}: parameters "
                  "differ from the unsharded step's")
        check(got["census"]["total"] == 0,
              f"dist_train_one_card {arch}: collectives on one device "
              f"{got['census']}")
        want[got["variant"]][0] += DIST_STEPS * 2 * got["calls"]
        want[got["variant"]][1] += DIST_STEPS * got["calls"]
        emit({"phase": "dist_train_one_card", "arch": arch,
              "reduced": arch != "qwen3_0_6b", "mesh": [1, 1, 1],
              "mesh_dims": mesh_dims, "backend": "nccl",
              "steps": DIST_STEPS, "batch": [b, s],
              "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
              "optimizer": cfg.optimizer,
              "losses_dtensor": got["losses"],
              "losses_unsharded": ref["losses"], "bit_equal": True,
              "params_bit_equal": params_equal,
              "step_s_dtensor": got["step_s"],
              "step_s_unsharded": ref["step_s"],
              "max_memory_allocated_bytes": got["peak"],
              "census": got["census"], "variant": got["variant"],
              "flash_fwd_launches_per_step": 2 * got["calls"],
              "flash_bwd_launches_per_step": got["calls"]})
    seconds = now() - t_phase
    emit({"phase": "dist_train_one_card", "archs": [c[0] for c in cases],
          "seconds": seconds, "budget_s": DIST_BUDGET_S})
    check(seconds <= DIST_BUDGET_S,
          f"dist_train_one_card took {seconds:.1f} s, over its "
          f"{DIST_BUDGET_S} s")
    return {v: tuple(n) for v, n in want.items()}


def phase_dist_serve_one_card(torch, lm_mod, configs, train_step_mod,
                              pipeline, mesh_mod, cells, fa_mod, reset):
    """`dist_serve_one_card`: the serving path over a mesh (prefill
    and decode on a placed model, `train_step.place_batch`,
    `LM.init_cache` over the mesh, the decode step's weights and cache
    in place) on an NCCL world of one process (mesh (1, 1, 1)), against
    the unsharded model from the same seed: Qwen3-0.6B at full width in
    float32, `LM.prefill` of SERVE_MESH_B x SERVE_MESH_S (the pipeline's
    batch 0), its K/V in the first positions of a cache SERVE_MESH_STEPS
    longer, then SERVE_MESH_STEPS greedy decode steps (the mesh fed the
    unsharded run's tokens).  Gates: the prefill's logits and K/V and
    each decode step's logits within SERVE_MESH_SHARE of the largest
    magnitude (whether the prefill is bit-equal is printed), each
    step's pick equal, the prefill's flash launches
    one a layer (simt: float32) and none decoding, no collective, the
    phase within SERVE_MESH_BUDGET_S.  `reset` sets every launch count
    to 0 between the unsharded run and the mesh's, so the counts read
    after the phase are the mesh path's alone.  Returns the flash
    launches it must count."""
    import dataclasses

    t_phase = now()
    cfg = dataclasses.replace(configs.get_config("qwen3_0_6b"),
                              compute_dtype="float32")
    calls = attention_calls(cfg)
    b, s, steps = SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_STEPS
    data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                               seq_len=s, global_batch=b,
                               modality=cfg.modality, d_model=cfg.d_model,
                               n_image_tokens=cfg.n_image_tokens)
    prompt = torch.from_numpy(pipeline.make_batch(data, 0)["tokens"]).to(
        "cuda")

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def run(mesh, fed):
        model = lm_mod.build_model(
            cfg, device="cuda", mesh=mesh,
            generator=torch.Generator(device="cuda").manual_seed(0))

        def place(tokens):
            return tokens if mesh is None else train_step_mod.place_batch(
                {"tokens": tokens}, mesh)["tokens"]

        before = _launches(fa_mod)
        census = cells.CollectiveCensus()
        torch.cuda.synchronize()
        t0 = now()
        with census:
            logits, pre = model.prefill({"tokens": place(prompt)})
        torch.cuda.synchronize()
        out = {"prefill_s": now() - t0, "logits": [whole(logits)],
               "kv": [whole(t) for kv in pre["kv"] for t in kv]}
        _check_step_launches(fa_mod, before, calls,
                             "dist_serve_one_card prefill", train=False,
                             variant="simt")
        cache = model.init_cache(b, s + steps, dtype=torch.float32)
        # One rank's shard of a DTensor is the whole tensor.
        for kv, leaves in zip(pre["kv"], cache.values()):
            for t, name in zip(kv, ("k", "v")):
                local = leaves[name].to_local() if mesh is not None \
                    else leaves[name]
                local[..., :s, :] = t.to_local() if mesh is not None else t
        del pre
        tok = torch.argmax(out["logits"][0][:, -1], dim=-1)[:, None]
        out["fed"], out["step_ms"] = [], []
        before = _launches(fa_mod)
        for i in range(steps):
            tok = tok if fed is None else fed[i]
            out["fed"].append(tok)
            torch.cuda.synchronize()
            t0 = now()
            with census:
                step_logits, cache = model.decode_step(
                    cache, place(tok.to(torch.int32)), s + i)
            torch.cuda.synchronize()
            out["step_ms"].append((now() - t0) * 1e3)
            out["logits"].append(whole(step_logits))
            tok = torch.argmax(out["logits"][-1][:, -1], dim=-1)[:, None]
        check(_launches(fa_mod) == before, "dist_serve_one_card: flash "
              f"launches while decoding: {before} -> {_launches(fa_mod)}")
        out["census"] = census.result()
        del model, cache
        torch.cuda.empty_cache()
        return out

    plain = run(None, None)
    reset()
    mesh = mesh_mod.init_train_mesh(
        (1, 1, 1), device="cuda", init_method=f"tcp://localhost:{free_port()}",
        world_size=1, rank=0)
    try:
        torch.cuda.reset_peak_memory_stats()
        placed = run(mesh, plain["fed"])
        placed["peak"] = torch.cuda.max_memory_allocated()
    finally:
        mesh_mod.close_train_mesh()
    prefill_equal = torch.equal(placed["logits"][0], plain["logits"][0]) \
        and all(torch.equal(x, y) for x, y in zip(placed["kv"], plain["kv"]))
    errs = [((x - y).abs().max() / y.abs().max()).item()
            for x, y in zip(placed["logits"] + placed["kv"],
                            plain["logits"] + plain["kv"])]
    picks = [torch.argmax(x[:, -1], dim=-1) for x in placed["logits"][1:]]
    want = [torch.argmax(y[:, -1], dim=-1) for y in plain["logits"][1:]]
    check(max(errs) <= SERVE_MESH_SHARE,
          f"dist_serve_one_card: logits or K/V {max(errs):.3g} of the "
          f"largest from the unsharded run's, bound {SERVE_MESH_SHARE}")
    check(all(torch.equal(x, y) for x, y in zip(picks, want)),
          "dist_serve_one_card: greedy picks differ from the unsharded "
          "steps'")
    check(placed["census"]["total"] == 0,
          f"dist_serve_one_card: collectives on one device "
          f"{placed['census']}")
    seconds = now() - t_phase
    emit({"phase": "dist_serve_one_card", "arch": "qwen3_0_6b",
          "compute_dtype": "float32", "mesh": [1, 1, 1], "backend": "nccl",
          "prefill": [b, s], "decode_steps": steps,
          "prefill_s_mesh": placed["prefill_s"],
          "prefill_s_unsharded": plain["prefill_s"],
          "decode_ms_mesh": placed["step_ms"],
          "decode_ms_unsharded": plain["step_ms"],
          "max_rel_err": max(errs), "prefill_bit_equal": prefill_equal,
          "picks_equal": True,
          "max_memory_allocated_bytes": placed["peak"],
          "census": placed["census"],
          "flash_fwd_launches_prefill": calls, "variant": "simt",
          "seconds": seconds, "budget_s": SERVE_MESH_BUDGET_S})
    check(seconds <= SERVE_MESH_BUDGET_S,
          f"dist_serve_one_card took {seconds:.1f} s, over its "
          f"{SERVE_MESH_BUDGET_S} s")
    return {"wgmma": 0, "simt": calls}


def reset_counts(matmul, flash, fa_mod) -> None:
    """Every kernel's launch counts to 0."""
    matmul.launches = 0
    matmul.launches_by_variant.update(wgmma=0, simt=0)
    flash.launches = 0
    flash.launches_by_variant.update(wgmma=0, simt=0)
    fa_mod.attend_backward.launches = 0
    fa_mod.attend_backward.launches_by_variant.update(wgmma=0, simt=0)


class flash_calls:
    """While active, records (Sq, Sk, D, causal) of every call of the
    LM's attention entry (`models.layers.flash_attention`, which the LM
    reaches through its module) in `self.calls`."""

    def __init__(self, layers):
        self.layers, self.calls = layers, []

    def __enter__(self):
        self.orig = self.layers.flash_attention

        def record(q, k, v, *, causal, **kw):
            self.calls.append((q.shape[2], k.shape[2], q.shape[3], causal))
            return self.orig(q, k, v, causal=causal, **kw)

        self.layers.flash_attention = record
        return self

    def __exit__(self, *exc):
        self.layers.flash_attention = self.orig


def runs_of(items: list) -> list:
    """[[*item, n], ...]: each run of equal consecutive items, counted."""
    out = []
    for item in items:
        if out and tuple(out[-1][:-1]) == tuple(item):
            out[-1][-1] += 1
        else:
            out.append([*item, 1])
    return out


def family_batch(torch, cfg, b, s, gen, device):
    """A batch of the family's inputs from `gen`: tokens (B, S), or
    HuBERT's frames (B, S, D) with labels; the VLM's image embeddings
    (B, n_image_tokens, D) in the compute type."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.modality == "audio":
        return {"frames": torch.randn((b, s, cfg.d_model), generator=gen,
                                      device=device).to(cdt),
                "labels": torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=gen, device=device)}
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s),
                                     generator=gen, device=device)}
    if cfg.modality == "vision+text":
        batch["image_embeds"] = torch.randn(
            (b, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=device).to(cdt)
    return batch


def phase_lm_family_prefill(torch, lm_mod, configs, flash, arch, phase,
                            expected_calls):
    """`LM.prefill` of FAMILY_B x FAMILY_S at the config's full width
    (depth FAMILY_DEPTH where the whole model does not fit the card),
    parameters drawn on the card from seed 0: a cold call, then a warm
    one.  Gates: the attention calls of each prefill are
    `expected_calls` ((Sq, Sk, D, causal) in order), each one flash
    launch on wgmma; the last logits finite.  Returns (model, batch)."""
    import dataclasses

    cfg = configs.get_config(arch)
    if arch in FAMILY_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_DEPTH[arch])
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = now()
    model = lm_mod.build_model(cfg, device="cuda", generator=gen)
    batch = family_batch(torch, cfg, FAMILY_B, FAMILY_S, gen, "cuda")
    torch.cuda.synchronize()
    init_s = now() - t0
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    secs, launches, on_wgmma, calls = [], [], [], []
    for _ in range(2):
        before, wgmma_before = flash.launches, \
            flash.launches_by_variant["wgmma"]
        with flash_calls(lm_mod.L) as rec:
            t0 = now()
            logits, cache = model.prefill(batch)
            torch.cuda.synchronize()
            secs.append(now() - t0)
        launches.append(flash.launches - before)
        on_wgmma.append(flash.launches_by_variant["wgmma"] - wgmma_before)
        calls.append(rec.calls)
        del cache
    n = len(expected_calls)
    check(calls == [list(expected_calls)] * 2 and launches == [n, n]
          and on_wgmma == launches,
          f"{phase}: attention calls {calls[0]}, flash launches {launches} "
          f"({on_wgmma} on wgmma); expected {expected_calls}, all on wgmma")
    finite = bool(torch.isfinite(logits).all())
    check(finite and tuple(logits.shape) == (FAMILY_B, 1, cfg.vocab_size),
          f"{phase}: logits {tuple(logits.shape)}, finite {finite}")
    tokens_n = FAMILY_B * FAMILY_S
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "depth_cut": arch in FAMILY_DEPTH, "params": n_params,
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
          "batch": FAMILY_B, "seq": FAMILY_S, "init_seconds": init_s,
          "seconds_cold": secs[0], "seconds_warm": secs[1],
          "tokens_per_s_warm": tokens_n / secs[1],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "attention_calls_sq_sk_d_causal_count": runs_of(calls[0]),
          "flash_launches_per_call": launches,
          "flash_wgmma_launches_per_call": on_wgmma,
          "logits_finite": finite})
    return model, batch


def phase_lm_family_serve(torch, serve, lm_mod, flash, model, phase,
                          image_embeds=None):
    """The serve loop at full width through `serve_step`: FAMILY_B
    requests, prompt FAMILY_PROMPT, FAMILY_GEN generated greedily (the
    serve CLI's prompts from seed 0; the VLM with `image_embeds`).
    Gates: tokens in range; the attention calls are the cross slots'
    (one a decode step, Sq = 1 over the image keys, on wgmma) and no
    other."""
    cfg = model.cfg
    args = serve.parse_args(["--batch", str(FAMILY_B), "--prompt-len",
                             str(FAMILY_PROMPT), "--gen", str(FAMILY_GEN),
                             "--seed", "0"])
    prompts = serve.prompts_for(args, cfg.vocab_size).to("cuda")
    before, wgmma_before = flash.launches, flash.launches_by_variant["wgmma"]
    with flash_calls(lm_mod.L) as rec:
        seq, secs = serve.decode(model, prompts, FAMILY_GEN, now,
                                 image_embeds=image_embeds)
    launches = flash.launches - before
    on_wgmma = flash.launches_by_variant["wgmma"] - wgmma_before
    steps = FAMILY_PROMPT + FAMILY_GEN - 1
    n_cross = sum(s.cross for s in model.slots) * model.n_periods
    expected = [(1, cfg.n_image_tokens, cfg.head_dim, False)] \
        * (steps * n_cross)
    check(tuple(seq.shape) == (FAMILY_B, FAMILY_PROMPT + FAMILY_GEN)
          and bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
          f"{phase}: served tokens {tuple(seq.shape)}")
    check(rec.calls == expected and launches == on_wgmma == len(expected),
          f"{phase}: {len(rec.calls)} attention calls "
          f"({rec.calls[:2]}...), {launches} flash launches; "
          f"expected {len(expected)} cross calls on wgmma")
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "batch": FAMILY_B, "prompt_len": FAMILY_PROMPT, "gen": FAMILY_GEN,
          "seconds": secs, "tok_per_s": seq.numel() / secs,
          "decode_steps": steps, "flash_launches": launches,
          "sample": seq[0, FAMILY_PROMPT - 8:FAMILY_PROMPT + 12].tolist()})


def phase_lm_mamba_prefill_vs_decode(torch, lm_mod, model):
    """Mamba-2 at full width: `prefill` of MAMBA_STEP_PROMPT tokens (2
    prompts) against stepping `decode_step` through them (the chunked
    SSD against the exact recurrence): the last logits, in float32
    compute within DECODE_TOL_F32, in bfloat16 compute within
    MAMBA_BF16_GAP (absolute)."""
    import dataclasses

    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(1, model.cfg.vocab_size, (2, MAMBA_STEP_PROMPT),
                           generator=gen, device="cuda")
    out = {}
    for cdt, tol in (("float32", DECODE_TOL_F32),
                     ("bfloat16", MAMBA_BF16_GAP)):
        cfg = dataclasses.replace(model.cfg, compute_dtype=cdt)
        m = lm_mod.build_model(cfg, device="cuda", params=model.params)
        logits_p, _ = m.prefill({"tokens": tokens})
        cache = m.init_cache(2, MAMBA_STEP_PROMPT)
        t0 = now()
        for pos in range(MAMBA_STEP_PROMPT):
            logits_d, cache = m.decode_step(cache, tokens[:, pos:pos + 1],
                                            pos)
        torch.cuda.synchronize()
        step_ms = (now() - t0) * 1e3 / MAMBA_STEP_PROMPT
        rtol = tol if cdt == "float32" else 0.0
        torch.testing.assert_close(logits_d.float(), logits_p.float(),
                                   rtol=rtol, atol=tol,
                                   msg=lambda m: f"Mamba-2 {cdt}: {m}")
        out[cdt] = {"max_abs_err": (logits_d - logits_p).abs().max().item(),
                    "max_abs_logit": logits_p.abs().max().item(),
                    "tolerance": tol, "decode_ms_per_step": step_ms}
    emit({"phase": "lm_mamba2_prefill_vs_decode",
          "prompt_len": MAMBA_STEP_PROMPT, "batch": 2,
          "reference_bf16_gap_cpu": MAMBA_REF_GAP, **out})


def named_leaves(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict of tensors."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {name: leaf for k in sorted(tree)
            for name, leaf in named_leaves(tree[k], f"{prefix}/{k}").items()}


def phase_lm_serve_ckpt(torch, serve, model, ckpt_dir):
    """The serve CLI's two halves, `load_model` then `decode`, with
    `--ckpt-dir` on the checkpoint the uninterrupted training run wrote
    (Qwen3-0.6B at full width, step TRAIN_STEPS): every restored
    parameter is the trained model's, bit for bit (name, shape, type and
    values), and the served tokens equal serving the trained model
    directly.  Removes the checkpoint after."""
    import shutil

    ckpt = ckpt_dir / "clean"
    argv = ["--arch", "qwen3_0_6b", "--batch", "4", "--prompt-len",
            str(FAMILY_PROMPT), "--gen", str(FAMILY_GEN), "--device", "cuda",
            "--seed", "0"]
    args = serve.parse_args(argv + ["--ckpt-dir", str(ckpt)])
    logs = []
    t0 = now()
    restored = serve.load_model(args, log=logs.append)
    torch.cuda.synchronize()
    restore_s = now() - t0
    check(logs == [f"[serve] restored step {TRAIN_STEPS} from {ckpt}"],
          f"serve --ckpt-dir logged {logs}")
    got, want = named_leaves(restored.params), named_leaves(model.params)
    check(list(got) == list(want),
          f"restored leaves {sorted(set(got) ^ set(want))} differ in name")
    unequal = [n for n in want if got[n].device != want[n].device
               or got[n].dtype != want[n].dtype
               or not torch.equal(got[n], want[n])]
    check(not unequal, f"restored leaves not the trained ones: {unequal}")
    prompts = serve.prompts_for(args, restored.cfg.vocab_size).to("cuda")
    seq, secs = serve.decode(restored, prompts, args.gen, now)
    del restored
    direct, _ = serve.decode(model, prompts, FAMILY_GEN, now)
    equal = torch.equal(seq, direct)
    check(equal, "tokens served from the checkpoint != served directly")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "lm_serve_ckpt", "argv": argv + ["--ckpt-dir", "..."],
          "log": logs, "restore_seconds": restore_s,
          "leaves_equal": len(want), "serve_seconds": secs,
          "tokens_equal_direct": equal,
          "sample": seq[0, FAMILY_PROMPT - 8:FAMILY_PROMPT + 12].tolist()})


def phase_lm_families_card_vs_cpu(torch, lm_mod, configs):
    """Each family's reduced config in float32: parameters drawn on the
    CPU, the same tree on the card; prefill of 2 x 128 (two SSD chunks)
    and 3 decode steps, logits within FAMILY_CARD_CPU_TOL."""
    import dataclasses

    errs = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  compute_dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(0)
        cpu = lm_mod.build_model(cfg, device="cpu", generator=gen)
        card = lm_mod.build_model(
            cfg, device="cuda",
            params=lm_mod._tree_map(lambda t: t.detach().to("cuda"),
                                    cpu.params))
        batch = family_batch(torch, cfg, 2, 128, gen, "cpu")
        img = batch.get("image_embeds")
        pairs = [(cpu.prefill(batch)[0], card.prefill(
            {k: v.cuda() for k, v in batch.items()})[0])]
        cc, cg = cpu.init_cache(2, 4, torch.float32), \
            card.init_cache(2, 4, torch.float32)
        for pos in range(3):
            tok = torch.full((2, 1), 7 + pos)
            lc, cc = cpu.decode_step(cc, tok, pos, image_embeds=img)
            lg, cg = card.decode_step(
                cg, tok.cuda(), pos,
                image_embeds=None if img is None else img.cuda())
            pairs.append((lc, lg))
        for c, g in pairs:
            torch.testing.assert_close(g.cpu(), c, rtol=FAMILY_CARD_CPU_TOL,
                                       atol=FAMILY_CARD_CPU_TOL)
        errs[arch] = max((g.cpu() - c).abs().max().item() for c, g in pairs)
    emit({"phase": "lm_families_card_vs_cpu",
          "config": "reduced, float32: prefill 2 x 128, 3 decode steps",
          "logits_max_abs_err": errs, "tolerance": FAMILY_CARD_CPU_TOL})


class route_calls:
    """While active, records (probs, expert indices) of every call of the
    MoE router (`models.moe.route`, which the MoE layer reaches through
    its module) in `self.calls`, on the CPU."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = self.moe.route

        def record(params, cfg, x, *rest):
            probs, gate_w, gate_i = self.orig(params, cfg, x, *rest)
            self.calls.append((probs.detach().cpu(), gate_i.cpu()))
            return probs, gate_w, gate_i

        self.moe.route = record
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def routing_flips(cpu_calls, card_calls, limit: int = 3) -> dict:
    """Where the card's router picked other experts than the CPU's on the
    same step: the count of such tokens and the first `limit`, each with
    its (call, group, token), both picks and both devices' expert
    scores."""
    flips, first = 0, []
    for n, ((pc, ic), (pg, ig)) in enumerate(zip(cpu_calls, card_calls)):
        differ = (ic != ig).any(-1)
        flips += int(differ.sum())
        for g, t in differ.nonzero().tolist()[:limit - len(first)]:
            first.append({"call": n, "group": g, "token": t,
                          "experts_cpu": ic[g, t].tolist(),
                          "experts_card": ig[g, t].tolist(),
                          "scores_cpu": pc[g, t].tolist(),
                          "scores_card": pg[g, t].tolist()})
    return {"tokens": flips, "first": first,
            "calls": [len(cpu_calls), len(card_calls)]}


def phase_lm_family_train(torch, lm_mod, configs, train_step_mod, optimizer,
                          pipeline, fa_mod, arch, phase, depth,
                          expected_calls, profile=False, keep=False):
    """Training of `arch` at its config's published widths (depth `depth`
    where given) through `make_train_step`, parameters drawn on the card
    from seed 0, TRAIN_FAMILY_STEPS steps of the data pipeline's batches.
    Gates: every loss finite; every step's attention calls (with remat:
    each forward call again in the backward pass) are `expected_calls`
    twice over, each one flash forward launch, and one backward launch
    per forward call, all on wgmma; no flash launch where there is no
    attention.  Printed beside the steps' losses and learning rates:
    the loss of the initial parameters on each step's batch (finite).
    With `profile`, two more steps run, the second profiled.  Returns
    (the backward launches of all the steps, None), or with `keep` the
    model and its training state in place of None (for
    `dryrun_vs_card`), which the caller frees."""
    import dataclasses
    from collections import Counter

    full = configs.get_config(arch)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         n_layers=depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    model = lm_mod.build_model(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    tcfg = train_step_mod.TrainConfig(
        opt=optimizer.OptConfig(lr=3e-4, warmup_steps=20))
    step_fn, init_opt = train_step_mod.make_train_step(model, tcfg)
    params = model.params
    opt = init_opt(tcfg.opt, params)
    torch.cuda.synchronize()
    init_s = now() - t0
    n_params = sum(p.numel() for p in model.parameters())
    data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                               seq_len=TRAIN_FAMILY_S,
                               global_batch=TRAIN_FAMILY_B,
                               modality=cfg.modality, d_model=cfg.d_model,
                               n_image_tokens=cfg.n_image_tokens)
    n_calls = sum(n for _, n in expected_calls)
    want = Counter({call: 2 * n for call, n in expected_calls})

    def batch_of(step):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in pipeline.make_batch(data, step).items()}

    # The initial parameters' loss on each step's batch: beside the
    # steps' losses it tells what the updates changed from the spread
    # of the batches.
    with torch.no_grad():
        initial = [float(model.train_loss(batch_of(step), params)[0])
                   for step in range(TRAIN_FAMILY_STEPS)]
    losses, secs, steps = [], [], []
    for step in range(TRAIN_FAMILY_STEPS):
        batch = batch_of(step)
        fwd = dict(fa_mod.flash_attention.launches_by_variant)
        bwd = dict(fa_mod.attend_backward.launches_by_variant)
        torch.cuda.synchronize()
        with flash_calls(lm_mod.L) as rec:
            t0 = now()
            params, opt, met = step_fn(params, opt, batch)
            losses.append(float(met["loss"]))
            secs.append(now() - t0)
        steps.append((
            {v: n - fwd[v] for v, n in
             fa_mod.flash_attention.launches_by_variant.items()},
            {v: n - bwd[v] for v, n in
             fa_mod.attend_backward.launches_by_variant.items()},
            Counter(rec.calls)))
        del batch
    peak = torch.cuda.max_memory_allocated()
    check(all(x == x and abs(x) < float("inf") for x in losses + initial),
          f"{phase}: non-finite losses {losses}, initial {initial}")
    per_step = {"wgmma": 2 * n_calls, "simt": 0}
    check(all(f == per_step and b == {"wgmma": n_calls, "simt": 0}
              and calls == want for f, b, calls in steps),
          f"{phase}: per step (forward, backward launches by variant, "
          f"attention calls) {steps}; expected {per_step}, "
          f"{n_calls} backward on wgmma, calls {dict(want)}")
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_FAMILY_B * TRAIN_FAMILY_S
    line = {"phase": phase, "arch": cfg.name,
            "layers_run_of_published": [cfg.n_layers, full.n_layers],
            "params": n_params, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "optimizer": cfg.optimizer,
            "remat": cfg.remat, "batch": TRAIN_FAMILY_B,
            "seq": TRAIN_FAMILY_S,
            "head_dim": cfg.head_dim, "init_seconds": init_s,
            "losses": losses, "losses_of_initial_params": initial,
            "learning_rates": [
                float(optimizer.schedule(tcfg.opt, torch.tensor(i + 1.0)))
                for i in range(TRAIN_FAMILY_STEPS)],
            "step_seconds": secs,
            "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "max_memory_allocated_bytes": peak,
            "attention_calls_per_step_sq_sk_d_causal_count":
                [[*call, n] for call, n in expected_calls],
            "flash_fwd_launches_per_step": steps[-1][0],
            "flash_bwd_launches_per_step": steps[-1][1]}
    if profile:
        batch = batch_of(0)
        line["profiled_step"], params, opt = profile_step(
            torch, step_fn, params, opt, batch)
    emit(line)
    # Backward launches: every step's, the profiled and its warm one too.
    n_bwd = n_calls * (TRAIN_FAMILY_STEPS + 2 * profile)
    if keep:
        return n_bwd, {"model": model, "params": params, "opt": opt,
                       "step_fn": step_fn, "opt_cfg": tcfg.opt,
                       "batch": batch_of(0), "step_s": step_s,
                       "calls_per_step": n_calls}
    del model, params, opt, step_fn
    torch.cuda.empty_cache()
    return n_bwd, None


def phase_lm_train_families_card_vs_cpu(torch, lm_mod, configs,
                                        train_step_mod, optimizer,
                                        pipeline):
    """Each family's reduced config in float32 (compute and parameters),
    3 steps of `make_train_step` on the config's optimizer and the data
    pipeline's batches (2 x 128), on the card and on the CPU.  Every step
    starts on both devices from the same parameters and optimizer state
    (the card's, copied to the CPU).  Held: each parameter leaf's
    gradient of that state and the step's gradient norm within
    TRAIN_GRAD_CARD_CPU, the step's loss and the parameters after it
    within TRAIN_CARD_CPU.  (Run free, the two devices' float32 sums
    differ in the last bits and Adam, which divides each gradient
    element by its own running magnitude, turns that into up to lr a
    step on an element whose gradient is near zero:
    tests/torch_adam_drift_card.py measures it.)  The MoE router's picks
    are compared too: a token routed otherwise on the card is reported
    with both devices' expert scores."""
    import dataclasses

    def leaves(params, opt):
        return optimizer.tree_leaves(params) + optimizer.tree_leaves(opt)

    def names(tree, prefix=""):
        return [n for k in sorted(tree) for n in (
            names(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict)
            else [prefix + k])]

    def grads(model, params, batch):
        flat = optimizer.tree_leaves(params)
        with torch.enable_grad():
            loss, _ = model.train_loss(batch, params)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        return [torch.zeros(p.shape) if g is None else g.detach().cpu()
                for p, g in zip(flat, got)]

    out, flips = {}, {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  compute_dtype="float32",
                                  param_dtype="float32")
        gen = torch.Generator(device="cpu").manual_seed(0)
        models = {"cpu": lm_mod.build_model(cfg, device="cpu",
                                            generator=gen)}
        models["cuda"] = lm_mod.build_model(
            cfg, device="cuda",
            params=lm_mod._tree_map(lambda t: t.detach().to("cuda"),
                                    models["cpu"].params))
        tcfg = train_step_mod.TrainConfig(
            opt=optimizer.OptConfig(lr=1e-3, warmup_steps=2))
        data = pipeline.DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                   seq_len=128, global_batch=2,
                                   modality=cfg.modality,
                                   d_model=cfg.d_model,
                                   n_image_tokens=cfg.n_image_tokens)
        state, steps = {}, {}
        for name, model in models.items():
            steps[name], _ = train_step_mod.make_train_step(model, tcfg)
            state[name] = train_step_mod.init_train_state(model, tcfg)
        leaf_names = names(models["cpu"].params)
        losses = {"cpu": [], "cuda": []}
        norms = {"cpu": [], "cuda": []}
        loss_rel, norm_rel, grad_share, param_err = 0.0, 0.0, 0.0, 0.0
        routes = {"cpu": [], "cuda": []}
        tol = TRAIN_CARD_CPU["param_tol"]
        for step in range(3):
            with torch.no_grad():     # the CPU starts from the card's state
                for dst, src in zip(leaves(*state["cpu"]),
                                    leaves(*state["cuda"])):
                    dst.copy_(src)
            g = {}
            for name in ("cpu", "cuda"):
                batch = {k: torch.from_numpy(v).to(name) for k, v in
                         pipeline.make_batch(data, step).items()}
                g[name] = grads(models[name], state[name][0], batch)
                with route_calls(lm_mod.M) as rec:
                    params, opt, met = steps[name](*state[name], batch)
                state[name] = (params, opt)
                routes[name] += rec.calls
                losses[name].append(float(met["loss"]))
                norms[name].append(float(met["grad_norm"]))
            flips[arch] = routing_flips(routes["cpu"], routes["cuda"]) \
                if cfg.n_experts else None
            lc, lg = losses["cpu"][-1], losses["cuda"][-1]
            loss_rel = max(loss_rel, abs(lg - lc) / abs(lc))
            check(abs(lg - lc) <= TRAIN_CARD_CPU["loss_rtol"] * abs(lc),
                  f"{arch} step {step}: loss card {lg} != cpu {lc}; "
                  f"routing flips {flips[arch]}")
            for leaf, gc, gg in zip(leaf_names, g["cpu"], g["cuda"]):
                share = ((gg - gc).abs().max()
                         / gc.abs().max().clamp_min(1e-30)).item()
                check(share <= TRAIN_GRAD_CARD_CPU["grad_share"],
                      f"{arch} step {step}: gradient of {leaf} card != cpu,"
                      f" max err {share} of its largest; routing flips "
                      f"{flips[arch]}")
                grad_share = max(grad_share, share)
            nc, ng = norms["cpu"][-1], norms["cuda"][-1]
            norm_rel = max(norm_rel, abs(ng - nc) / abs(nc))
            check(abs(ng - nc) <= TRAIN_GRAD_CARD_CPU["grad_norm_rtol"]
                  * abs(nc),
                  f"{arch} step {step}: grad norm card {ng} != cpu {nc}")
            for a, b in zip(optimizer.tree_leaves(state["cuda"][0]),
                            optimizer.tree_leaves(state["cpu"][0])):
                a = a.detach().cpu()
                check(torch.allclose(a, b, rtol=tol, atol=tol),
                      f"{arch} step {step}: parameters card != cpu beyond "
                      f"{tol}, max {(a - b).abs().max().item()}; routing "
                      f"flips {flips[arch]}")
                param_err = max(param_err, (a - b).abs().max().item())
        out[arch] = {"losses_cpu": losses["cpu"],
                     "losses_cuda": losses["cuda"],
                     "loss_max_rel_diff": loss_rel,
                     "grad_norms_cpu": norms["cpu"],
                     "grad_norm_max_rel_diff": norm_rel,
                     "grad_max_err_share_of_leaf_max": grad_share,
                     "param_max_abs_diff_per_step": param_err,
                     "optimizer": cfg.optimizer}
    emit({"phase": "lm_train_families_card_vs_cpu",
          "config": "reduced, float32 compute and parameters, 3 steps of "
                    "2 x 128 from the data pipeline, each config's "
                    "optimizer, each step from the card's state",
          "families": out, "routing_flips": flips,
          "tolerances": {**TRAIN_CARD_CPU, **TRAIN_GRAD_CARD_CPU}})


def flash_shape_timing(torch, attend, attention_ref, flash, shape, causal,
                       seed):
    """The bf16 wgmma kernel at `shape` (b, hq, hkv, s, d) against the
    plain version (its error and time) and SDPA, with the bound from
    the visible (q, k) pairs' FLOPs and q, k, v, o's bytes."""
    import torch.nn.functional as F

    b, hq, hkv, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    before = dict(flash.launches_by_variant)
    out = attend(q, k, v, causal=causal)
    ran_on(flash.launches_by_variant, before, "wgmma", f"flash {shape}")
    ref = plain_attention(attention_ref, q, k, v, causal, 0)
    err, atol = flash_close(torch, out, ref, "bfloat16", f"flash {shape}")
    excess = (None if causal else
              missing_tile_excess(torch, attention_ref, q, k, v, ref, atol))
    del out, ref
    ms = cuda_ms(lambda: attend(q, k, v, causal=causal), reps=10)
    plain_ms = cuda_ms(lambda: plain_attention(attention_ref, q, k, v,
                                               causal, 0),
                       warmup=1, iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), reps=10)
    pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
    flops = 4.0 * d * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"shape_b_hq_hkv_s_d": list(shape), "causal": causal,
            "max_abs_err": err, "atol": atol, "missing_tile_excess": excess,
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tflops": flops / (ms * 1e-3) / 1e12}


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
    err, _ = flash_close(torch, kern, ref, "bfloat16", "flash timing")
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
           "library_ms": library_ms, "held_against_plain": True,
           "other_head_dims": [
               flash_shape_timing(torch, attend, attention_ref, flash,
                                  shape, causal, seed)
               for shape, causal, seed in FLASH_TIMING_SHAPES]}
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
    164,904 B for flash at D 128, 133,160 B for each backward kernel up
    to D 128 and 198,696 B above) and the full compiler report."""
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
    import numpy as np

    from repro_torch import api, configs
    from repro_torch.analysis import contracts
    from repro_torch.analysis import report as an_report
    from repro_torch.core import (archspec, calibration, cosa, fleet,
                                  mapping, oracle, problem, rtl_sim, search,
                                  surrogate)
    from repro_torch.core.arch import GEMMINI_DEFAULT
    from repro_torch.core import tpu_model
    from repro_torch.core.baselines import random_search
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.flash_attention import (
        attend, flash_attention)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref,
                                                         attention_ref)
    from repro_torch.kernels.matmul.matmul import matmul
    from repro_torch.kernels.matmul.ops import tuned_blocks, tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.launch import cells, hillclimb, serve
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import lm as lm_mod
    from repro_torch.obs import telemetry as obs
    from repro_torch.runtime import chaos, faults
    from repro_torch.serve import cosearch_service as service_mod
    from repro_torch.serve import serve_step
    from repro_torch.serve import server as server_mod
    from repro_torch.train import optimizer
    from repro_torch.train import train_step as train_step_mod
    from repro_torch.workloads import dnn_zoo

    smi = smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_all(build, ["matmul", "flash_attention", "flash_attention_bwd"])
    phase_analysis_lint(an_report)
    phase_dryrun_cells(torch, cells, tpu_model)
    phase_hillclimb_qwen3(hillclimb)
    phase_kernel_vs_plain(torch, matmul, matmul_ref)
    phase_flash_vs_plain(torch, attend, attention_ref, flash_attention)
    phase_flash_bwd_vs_plain(torch, fa_mod, attention_ref, attention_lse_ref)

    # ---- main path 1: tuned matmul + co-search, counts from 0.
    reset_counts(matmul, flash_attention, fa_mod)
    x, y = phase_tuned_matmul(torch, tuned_matmul, tuned_blocks, matmul_ref,
                              matmul)
    wl, cfg, res = phase_cosearch(torch, search, oracle, dnn_zoo)
    phase_example_quickstart()
    mm_launches = matmul.launches_by_variant["wgmma"]
    check(mm_launches > 0,
          "the tuned path never launched the wgmma matmul kernel")
    emit({"phase": "main_path_launches", "path": "tuned_matmul+cosearch",
          "matmul": mm_launches,
          "matmul_by_variant": dict(matmul.launches_by_variant),
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})

    # ---- main path 2: LM prefill at full width, counts from 0 per call.
    reset_counts(matmul, flash_attention, fa_mod)
    model, fa_launches = phase_lm_prefill(torch, lm_mod, configs,
                                          flash_attention)
    check(fa_launches > 0, "prefill never launched the flash kernel")
    emit({"phase": "main_path_launches", "path": "lm_prefill",
          "matmul": matmul.launches, "flash_attention": fa_launches,
          "flash_attention_by_variant":
              dict(flash_attention.launches_by_variant),
          "flash_attention_bwd": fa_mod.attend_backward.launches})

    # ---- main path 3: the serve loop at full width.
    phase_lm_serve(torch, serve, configs, flash_attention)

    phase_profile_prefill(torch, model)
    phase_profile_decode(torch, model)
    phase_lm_prefill_vs_decode(torch, lm_mod, model)
    del model
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu(torch, lm_mod, configs, serve_step)

    # ---- main path 4: training at full width through launch.train,
    # counts from 0.
    reset_counts(matmul, flash_attention, fa_mod)
    bwd_launches, model, train_ckpt = phase_lm_train(torch, train_mod,
                                                     fa_mod, configs)
    check(bwd_launches > 0 and fa_mod.attend_backward.launches
          == bwd_launches, "training never launched the backward kernel")
    check(flash_attention.launches_by_variant["wgmma"] > 0,
          "training never launched the wgmma forward kernel")
    check(fa_mod.attend_backward.launches_by_variant["wgmma"]
          == bwd_launches, "training's backward did not run on wgmma")
    emit({"phase": "main_path_launches", "path": "lm_train",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_by_variant":
              dict(flash_attention.launches_by_variant),
          "flash_attention_bwd": fa_mod.attend_backward.launches,
          "flash_attention_bwd_by_variant":
              dict(fa_mod.attend_backward.launches_by_variant)})
    # ---- main path 5: serving the trained checkpoint (--ckpt-dir).
    reset_counts(matmul, flash_attention, fa_mod)
    phase_lm_serve_ckpt(torch, serve, model, train_ckpt)
    emit({"phase": "main_path_launches", "path": "lm_serve_ckpt",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})
    phase_profile_train_step(torch, model, train_step_mod, optimizer,
                             pipeline)
    del model
    torch.cuda.empty_cache()
    phase_lm_train_card_vs_cpu(torch, lm_mod, configs, train_step_mod,
                               optimizer, pipeline)
    phase_dryrun_vs_card_qwen3(torch, cells, tpu_model, lm_mod, configs,
                               train_step_mod, optimizer, pipeline, fa_mod,
                               smi)

    # ---- main path 5b: the DTensor training path over a one-card NCCL
    # mesh, counts from 0 between the phase's unsharded reference run and
    # the DTensor run (the phase calls the reset), read after it.
    dist_want = phase_dist_train_one_card(
        torch, lm_mod, configs, train_step_mod, optimizer, pipeline,
        mesh_mod, cells, fa_mod,
        lambda: reset_counts(matmul, flash_attention, fa_mod))
    want = {"flash_attention": {v: n[0] for v, n in dist_want.items()},
            "flash_attention_bwd": {v: n[1] for v, n in dist_want.items()}}
    got = {"flash_attention": dict(flash_attention.launches_by_variant),
           "flash_attention_bwd":
               dict(fa_mod.attend_backward.launches_by_variant)}
    check(got == want and matmul.launches == 0,
          f"dist_train_one_card: the DTensor path's launches {got} "
          f"(matmul {matmul.launches}), expected {want} and no matmul")
    emit({"phase": "main_path_launches", "path": "dist_train_one_card",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_by_variant":
              dict(flash_attention.launches_by_variant),
          "flash_attention_bwd": fa_mod.attend_backward.launches,
          "flash_attention_bwd_by_variant":
              dict(fa_mod.attend_backward.launches_by_variant)})

    # ---- main path 5c: prefill and decode over a one-card NCCL mesh,
    # counts from 0 between the phase's unsharded run and the mesh's,
    # read after it.
    serve_want = phase_dist_serve_one_card(
        torch, lm_mod, configs, train_step_mod, pipeline, mesh_mod, cells,
        fa_mod, lambda: reset_counts(matmul, flash_attention, fa_mod))
    got = {"flash_attention": dict(flash_attention.launches_by_variant),
           "flash_attention_bwd":
               dict(fa_mod.attend_backward.launches_by_variant)}
    check(got == {"flash_attention": serve_want,
                  "flash_attention_bwd": {"wgmma": 0, "simt": 0}}
          and matmul.launches == 0,
          f"dist_serve_one_card: the mesh path's launches {got} (matmul "
          f"{matmul.launches}), expected {serve_want} forward and nothing "
          f"else")
    emit({"phase": "main_path_launches", "path": "dist_serve_one_card",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_by_variant":
              dict(flash_attention.launches_by_variant),
          "flash_attention_bwd": fa_mod.attend_backward.launches,
          "flash_attention_bwd_by_variant":
              dict(fa_mod.attend_backward.launches_by_variant)})

    # ---- main paths 6-10: training of the other families at full
    # width, counts from 0 before each path and read after it.
    for arch, phase, depth, expected_calls in TRAIN_FAMILIES:
        reset_counts(matmul, flash_attention, fa_mod)
        n_bwd, kept = phase_lm_family_train(
            torch, lm_mod, configs, train_step_mod, optimizer, pipeline,
            fa_mod, arch, phase, depth, expected_calls,
            profile=arch == TRAIN_FAMILY_PROFILED,
            keep=arch == DRYRUN_CARD_FAMILY)
        check(fa_mod.attend_backward.launches_by_variant
              == {"wgmma": n_bwd, "simt": 0},
              f"{arch}: backward launches "
              f"{fa_mod.attend_backward.launches_by_variant}, expected "
              f"{n_bwd} on wgmma")
        emit({"phase": "main_path_launches", "path": f"lm_train_{arch}",
              "matmul": matmul.launches,
              "flash_attention": flash_attention.launches,
              "flash_attention_by_variant":
                  dict(flash_attention.launches_by_variant),
              "flash_attention_bwd": fa_mod.attend_backward.launches,
              "flash_attention_bwd_by_variant":
                  dict(fa_mod.attend_backward.launches_by_variant)})
        if kept is not None:
            phase_dryrun_vs_card_train(
                torch, cells, tpu_model, fa_mod, smi,
                f"{arch}_{kept['model'].cfg.n_layers}_layers_train", kept,
                measured_s=kept["step_s"])
            del kept
            torch.cuda.empty_cache()
    phase_lm_train_families_card_vs_cpu(torch, lm_mod, configs,
                                        train_step_mod, optimizer, pipeline)

    # ---- main paths 11-14: the other families' prefill and serving at
    # full width, counts from 0 before each path and read after it.
    s, hd = FAMILY_S, 128
    for arch, phases, expected_calls in (
            ("jamba_v0_1_52b",
             ("lm_prefill_jamba_period", "lm_serve_jamba_period"),
             [(s, s, hd, True)]),
            ("mamba2_1_3b",
             ("lm_prefill_mamba2_1_3b", "lm_serve_mamba2_1_3b"), []),
            ("llama_3_2_vision_90b",
             ("lm_prefill_llama_vision_period",
              "lm_serve_llama_vision_period"),
             [(s, s, hd, True)] * 5 + [(s, s, hd, False)]),
            ("hubert_xlarge", ("lm_encode_hubert_xlarge", None),
             [(s, s, 80, False)] * 48)):
        reset_counts(matmul, flash_attention, fa_mod)
        fam, batch = phase_lm_family_prefill(
            torch, lm_mod, configs, flash_attention, arch, phases[0],
            expected_calls)
        if phases[1]:
            phase_lm_family_serve(torch, serve, lm_mod, flash_attention, fam,
                                  phases[1], batch.get("image_embeds"))
        check((flash_attention.launches > 0) == bool(expected_calls),
              f"{arch}: {flash_attention.launches} flash launches on its "
              "prefill and serve path")
        emit({"phase": "main_path_launches", "path": f"lm_{arch}",
              "matmul": matmul.launches,
              "flash_attention": flash_attention.launches,
              "flash_attention_by_variant":
                  dict(flash_attention.launches_by_variant),
              "flash_attention_bwd": fa_mod.attend_backward.launches})
        if arch == "mamba2_1_3b":
            phase_lm_mamba_prefill_vs_decode(torch, lm_mod, fam)
        del fam, batch
        torch.cuda.empty_cache()
    phase_lm_families_card_vs_cpu(torch, lm_mod, configs)
    phase_chunk_sync_free(torch, search, wl, cfg, res)
    gd_resnet50 = phase_profile_gd(torch, search, wl, cfg)
    phase_card_vs_cpu(search, problem)

    # ---- the paper's Sec. 6 experiments, counts from 0 (no kernel of
    # this repo is on these paths).
    reset_counts(matmul, flash_attention, fa_mod)
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
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})

    # ---- the co-search service slice, counts from 0 (no kernel of this
    # repo is on these paths): device seeding, the device-seeded search,
    # fleet search, the service behind its HTTP front-end.
    reset_counts(matmul, flash_attention, fa_mod)
    phase_device_seed(torch, np, mapping, dnn_zoo)
    phase_device_seeded_search(torch, search, mapping, oracle, wl, res,
                               gd_resnet50)
    phase_fleet(torch, fleet, search, oracle, archspec, obs, wl, problem)
    phase_service_http(torch, search, api, service_mod, server_mod, chaos,
                       problem, wl)
    emit({"phase": "main_path_launches",
          "path": "device_seed+fleet+service",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})

    # ---- population sharding over a pop mesh of repeated cuda:0 (and
    # every card where there are several), counts from 0 (no kernel of
    # this repo is on this path).
    reset_counts(matmul, flash_attention, fa_mod)
    phase_pop_shards(torch, search, fleet, mapping, archspec, api,
                     service_mod, faults, problem, wl)
    emit({"phase": "main_path_launches", "path": "pop_shards",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})

    # ---- the analysis suite's engine contracts, counts from 0 (no
    # kernel of this repo is on this path).
    reset_counts(matmul, flash_attention, fa_mod)
    phase_analysis_contracts(torch, an_report, contracts)
    emit({"phase": "main_path_launches", "path": "analysis_contracts",
          "matmul": matmul.launches,
          "flash_attention": flash_attention.launches,
          "flash_attention_bwd": fa_mod.attend_backward.launches})
    mm_row = phase_matmul_timing(torch, matmul, matmul_ref, x, y,
                                 mm_launches)
    fa_row = phase_flash_timing(torch, attend, attention_ref,
                                flash_attention, fa_launches)
    bwd_row = phase_flash_bwd_timing(torch, fa_mod, attention_bwd_ref,
                                     bwd_launches)

    emit({"phase": "total", "seconds": now() - t_start})
    emit({"kernels": [mm_row, fa_row, bwd_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
