#!/usr/bin/env python3
"""Training and serving over four cards: the port's sharded training
step, prefill and decode on a mesh of NCCL processes, one a card.

    python3 chip_dist_train.py [--runs a,b,c,d,e,f,g,h,t,s]
        [--archs qwen3_0_6b,gemma_7b] [--parent-src DIR] [--skip d8,ebf16]

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
  shards, MHA, the untied 256k head.  `--archs` picks the models.
  After each mesh run the same step (the config, the optimizer, rank
  0's rows) is counted again in a fresh process on a fake mesh of the
  same shape and device type (`launch.mesh.fake_production_mesh`,
  meta tensors, no card), and that census must equal rank 0's NCCL
  census kind by kind and in operations: the dry-run's census counts
  what NCCL runs;
- (b) Qwen3-0.6B whole, bf16 compute, over mesh 1x2x2 through
  `launch.train` (`train_with_recovery`, a checkpoint of the whole
  state at the end, written by rank 0) against the single-card CLI's
  run: losses within rtol 1e-3 (`LOSS_BF16`, the bf16 step bound of
  tests/test_torch_train.py), the checkpoint's leaves those of the
  single-card one;
- (c) Gemma-7B whole (28 of 28 layers; one card cannot hold it with
  AdamW), bf16 compute, remat, AdamW, 3 steps of 8 x 512 over mesh
  1x2x2 through `make_train_step`: finite losses.

- (d) Phi-3.5-MoE at full width, 2 of its 32 layers in float32 (what
  one card holds with AdamW), over 1x2x2 and 1x1x4 against one card
  as (a) holds them (experts over "model": 8 or 4 a card); then 8 of
  32 layers (10.66B parameters, 171 GB of float32 state with AdamW),
  bf16 compute, remat, over 1x2x2: finite losses;
- (e) Mamba-2 1.3B whole (48 layers) in float32 over 1x1x4 (16 of 64
  SSD heads a card) and 2x2x1 against one card as (a); then whole in
  bf16 over 1x1x4 against one card's bf16 run, losses within rtol
  1e-3;
- (f) one Jamba period at full width (8 of 32 layers: 13.27B
  parameters, 212 GB of float32 state with AdamW), bf16 compute,
  remat, over 1x1x4 (4 experts and 32 SSD heads a card): finite
  losses;
- (g) HuBERT-XLarge whole in float32 over 1x1x4 and 1x2x2 against one
  card as (a);
- (h) one Llama-3.2-Vision period (5 of 100 layers, bf16 parameters,
  Adafactor, 4096 image embeddings a row) over 1x2x2 against one card,
  losses within rtol 1e-3;
- (t) Qwen3-0.6B whole, bf16 compute, remat, AdamW, over 1x1x4 at 16 x
  4096 rows (`ROWS`: what one device of the train_4k cell holds, 256 x
  4096 over 16 data shards): finite losses, each card's peak memory
  and the step times; the loss runs on the logits' vocabulary shards,
  a quarter of the 16 x 4095 x 151,936 float32 logits a card.  With
  `--parent-src DIR` (an unpacked older `src/`) the same run follows
  on that package, and its peak, or the error its first failed rank
  printed last (out of memory, where DTensor gathered the logits whole
  on every card), is printed beside it.  Then Qwen3-0.6B, 4 of its 28
  layers in float32, 4 x 4096 over 1x1x4 against one card as (a);
- (s) serving (`SERVE`): Qwen3-0.6B whole in float32 over 1x2x2 and
  1x1x4, and Gemma-7B whole with bf16 compute over 1x1x4 (head dim 256
  on the local shards), each `LM.prefill` of 4 x 4096 tokens (the
  pipeline's batch, seed 0), its K/V written into a cache of 4096 + 32
  positions, then 32 `LM.decode_step`s: one card greedy, each mesh fed
  one card's picks.  Gates: the prefill's and every step's logits
  within 1e-5 of one card's largest magnitude in float32 (the bound of
  tests/test_torch_dist_serve.py) and every decode step's greedy pick
  equal to one card's; in bf16 within 0.05 (the LM's bf16 bound in
  tests/test_torch_lm_families.py) and each pick equal wherever one
  card's two largest logits are more than twice that step's largest
  logit difference apart (a nearer tie may flip with bf16 rounding:
  the first four-card run flipped 3 of Gemma-7B's 128 picks); the flash launches a rank
  (one a layer in the prefill, none in a decode step); rank 0's NCCL
  census of one decode step equal, kind by kind and in operations, to
  the fake "cuda" mesh's census of the same step (`cells.fake_census`
  of a decode cell of 4 rows and 4128 positions).  Prints the prefill
  seconds and each decode step's milliseconds a token.

Every run gates each rank's flash launches a step (2 forward an
attention call with remat, 1 backward, all on the variant the compute
type picks: simt for float32, wgmma for bf16; Mamba-2 has none) and
prints the step times, tokens/s, each card's peak memory and the
collective census (`launch.cells.CollectiveCensus`, bytes a card by
kind) of a warm step.  Any failed gate exits non-zero.  The card's
name and power limit come last.
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
CONTROL_EPS = 1e-7
BC_MESH = (1, 2, 2)
# Parts (a) and (d)-(h): run key -> (part, arch, config overrides,
# meshes, gate).  "f32": losses within LOSS_F32 and parameters within
# PARAMS_F32 of one card's; "bf16": losses within rtol LOSS_BF16 of one
# card's at every step where one card's own run does not move further
# when its drawn parameters are scaled by (1 + CONTROL_EPS N(0, 1))
# (the control run; past that step the trajectory is chaotic, and the
# steps are printed, not gated); "finite": no one-card run (one card
# cannot hold it), finite losses.  Part (a)'s keys are "a_<arch>"
# (`--archs` picks them).  Mamba-2's float32 equality runs 4 of its 48
# layers: deeper, one card's own 3 steps are chaotic in float32
# (tests/torch_mamba2_chaos_card.py on an H100: with the parameters
# scaled by (1 + 1e-7 N(0, 1)), at 48 layers the third loss moved by
# 1.1% and the first gradient norm by 3.4e-4, at 16 layers the second
# loss by 2.3e-5; at 4 layers no printed digit).
CASES = {
    "a_qwen3_0_6b": ("a", "qwen3_0_6b",
                     dict(compute_dtype="float32", n_layers=4),
                     ((1, 4, 1), (1, 1, 4), (2, 2, 1)), "f32"),
    "a_gemma_7b": ("a", "gemma_7b", dict(compute_dtype="float32",
                                         n_layers=2),
                   ((1, 2, 2), (1, 1, 4)), "f32"),
    "d": ("d", "phi3_5_moe_42b", dict(compute_dtype="float32", n_layers=2),
          ((1, 2, 2), (1, 1, 4)), "f32"),
    "d8": ("d", "phi3_5_moe_42b", dict(n_layers=8), ((1, 2, 2),), "finite"),
    "e": ("e", "mamba2_1_3b", dict(compute_dtype="float32", n_layers=4),
          ((1, 1, 4), (2, 2, 1)), "f32"),
    "ebf16": ("e", "mamba2_1_3b", {}, ((1, 1, 4),), "bf16"),
    "f": ("f", "jamba_v0_1_52b", dict(n_layers=8), ((1, 1, 4),), "finite"),
    "g": ("g", "hubert_xlarge", dict(compute_dtype="float32"),
          ((1, 1, 4), (1, 2, 2)), "f32"),
    "h": ("h", "llama_3_2_vision_90b", dict(n_layers=5), ((1, 2, 2),),
          "bf16"),
    "t": ("t", "qwen3_0_6b", {}, ((1, 1, 4),), "finite"),
    "t_f32": ("t", "qwen3_0_6b", dict(compute_dtype="float32", n_layers=4),
              ((1, 1, 4),), "f32"),
}
# Run key -> (batch, sequence) where it is not (BATCH, SEQ).
ROWS = {"t": (16, 4096), "t_f32": (4, 4096)}
# The older package part (t) runs again on (`--parent-src`), or None.
PARENT_SRC = None
# Part (s): run key -> (arch, config overrides, meshes, logits bound
# as a share of one card's largest magnitude); `--archs` picks them too.
SERVE = {
    "s_qwen3_0_6b": ("qwen3_0_6b", dict(compute_dtype="float32"),
                     ((1, 2, 2), (1, 1, 4)), 1e-5),
    "s_gemma_7b": ("gemma_7b", {}, ((1, 1, 4),), 0.05),
}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 4096, 32
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


def attention_calls(cfg) -> int:
    """Attention calls of one forward pass: a self-attention call a
    layer that has one, and a cross-attention call a cross layer."""
    return sum(int(cfg.is_attn_layer(i)) + int(cfg.is_cross_attn_layer(i))
               for i in range(cfg.n_layers))


def _tcfg():
    """The training config of every run: the config's optimizer at lr
    3e-4, warmup 20."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig

    return TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=20))


def _train(torch, cfg, mesh, dev, keep_params: bool = True,
           perturb: float = 0.0, rows: tuple = (BATCH, SEQ)) -> dict:
    """STEPS steps of the pipeline's batches of `rows` (batch, sequence;
    seed 0: tokens, HuBERT's frames and labels, the VLM's image
    embeddings) through `make_train_step`, the model drawn from seed 0;
    the second step
    under the census.  Returns the losses, step seconds, per-step flash
    launches, the census, peak memory, the attention calls of a forward
    pass and, with `keep_params`, the final parameters (whole).  With
    `perturb` (one card only) every drawn parameter is scaled by
    (1 + perturb N(0, 1)) before the steps (the control run)."""
    from repro_torch.data.pipeline import DataConfig, make_batch_rows
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch.cells import CollectiveCensus
    from repro_torch.models.lm import build_model
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, rank_rows)

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = now()
    model = build_model(cfg, device=dev, mesh=mesh,
                        generator=torch.Generator(dev).manual_seed(0))
    if perturb:
        noise = torch.Generator(dev).manual_seed(1)
        with torch.no_grad():
            for p in tree_leaves(model.params):
                p.mul_(1 + perturb * torch.randn(p.shape, generator=noise,
                                                 device=dev))
    tcfg = _tcfg()
    step, _ = make_train_step(model, tcfg, mesh)
    params, opt = init_train_state(model, tcfg, mesh)
    _sync(torch)
    init_s = now() - t0
    out_mem = [_mem_gb(torch)]
    batch_rows, seq = rows
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch_rows, modality=cfg.modality,
                      d_model=cfg.d_model,
                      n_image_tokens=cfg.n_image_tokens)
    rows = (0, batch_rows) if mesh is None else rank_rows(mesh, batch_rows)
    out = {"losses": [], "grad_norms": [], "step_s": [], "launches": [],
           "init_s": init_s, "allocated_gb": out_mem,
           "calls": attention_calls(cfg)}
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
        out["grad_norms"].append(float(met["grad_norm"]))
        out["launches"].append(_step_launches(before, _launches(fa_mod)))
        out_mem.append(_mem_gb(torch))
        if i == 1:
            out["census"] = census.result()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if DEVICE == "cuda" else 0
    if keep_params:
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


def _serve(torch, cfg, mesh, dev, fed) -> dict:
    """Part (s) on this rank: prefill SERVE_BATCH x SERVE_PROMPT tokens
    (the pipeline's batch 0 of seed 0; this rank's rows over a mesh),
    the K/V written into a cache of SERVE_PROMPT + SERVE_STEPS
    positions, then SERVE_STEPS decode steps fed `fed` (SERVE_BATCH,
    SERVE_STEPS) tokens, or greedy where `fed` is None; the second
    step under the census.  Returns the prefill's and each step's
    logits (whole), the picks, the times and the flash launches."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.data.pipeline import DataConfig, make_batch_rows
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.launch.cells import CollectiveCensus
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.lm import build_model
    from repro_torch.train.train_step import place_batch, rank_rows

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, mesh=mesh,
                        generator=torch.Generator(dev).manual_seed(0))
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size,
                      seq_len=SERVE_PROMPT, global_batch=SERVE_BATCH,
                      modality=cfg.modality, d_model=cfg.d_model,
                      n_image_tokens=cfg.n_image_tokens)
    rows = (0, SERVE_BATCH) if mesh is None else rank_rows(mesh,
                                                          SERVE_BATCH)

    def place(tokens):
        tokens = tokens.to(dev, torch.int32)
        return tokens if mesh is None else \
            place_batch({"tokens": tokens}, mesh)["tokens"]

    prompt = torch.from_numpy(make_batch_rows(data, 0, *rows)["tokens"])
    before = _launches(fa_mod)
    _sync(torch)
    t0 = now()
    logits, pre = model.prefill({"tokens": place(prompt)})
    _sync(torch)
    out = {"prefill_s": now() - t0,
           "prefill_launches": _step_launches(before, _launches(fa_mod)),
           "prefill_logits": _whole(logits).cpu(), "logits": [],
           "picks": [], "fed": [], "step_ms": [], "decode_launches": None}
    cdt = dtype_of(cfg.compute_dtype)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS,
                             dtype=cdt)
    attn = [si for si, slot in enumerate(model.slots) if slot.kind == "attn"]
    for si, kv in zip(attn, pre["kv"]):
        for name, t in zip(("k", "v"), kv):
            leaf = cache[f"slot{si}"][name]
            if isinstance(leaf, DTensor):
                padded = torch.zeros(leaf.shape, dtype=cdt, device=dev)
                padded[..., :SERVE_PROMPT, :] = _whole(t)
                leaf.to_local().copy_(distribute_tensor(
                    padded, mesh, leaf.placements, src_data_rank=None)
                    .to_local())
                del padded
            else:
                leaf[..., :SERVE_PROMPT, :] = t
    del pre
    tok = torch.argmax(_whole(logits)[:, -1], dim=-1)[:, None]
    before = _launches(fa_mod)
    for i in range(SERVE_STEPS):
        if fed is not None:
            tok = fed[:, i:i + 1]
        out["fed"].append(tok.cpu())
        census = CollectiveCensus()
        _sync(torch)
        t0 = now()
        with census if i == 1 else contextlib.nullcontext():
            step_logits, cache = model.decode_step(
                cache, place(tok[slice(*rows)]), SERVE_PROMPT + i)
        whole = _whole(step_logits)
        _sync(torch)
        out["step_ms"].append((now() - t0) * 1e3)
        if i == 1:
            out["census"] = census.result()
        tok = torch.argmax(whole[:, -1], dim=-1)[:, None]
        out["picks"].append(tok.cpu())
        out["logits"].append(whole.cpu())
    out["decode_launches"] = _step_launches(before, _launches(fa_mod))
    out["picks"] = torch.cat(out["picks"], dim=1)
    out["fed"] = torch.cat(out["fed"], dim=1)
    out["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if DEVICE == "cuda" else 0
    out["calls"] = attention_calls(cfg)
    return out


def rank_main(run: str, rank: int, world: int, port: int) -> None:
    """One rank of `run`; rank 0 (and the single-card runs) write the
    result to OUT/<run>.pt, every rank its own summary to
    OUT/<run>.rank<r>.json."""
    import torch

    from repro_torch.launch.mesh import close_train_mesh, init_train_mesh

    key, mesh_name = run.rsplit("_", 1)
    part = run[0]
    shape = None if mesh_name in ("single", "control") else \
        tuple(int(n) for n in mesh_name.split("x"))
    if part == "b":
        res = _launch_train(torch, shape, port, rank, world,
                            OUT / f"ckpt_{run}")
    elif part == "s":
        mesh = None
        if shape is not None:
            mesh = init_train_mesh(shape, device=DEVICE,
                                   init_method=f"tcp://localhost:{port}",
                                   world_size=world, rank=rank)
        dev = torch.device(DEVICE, torch.cuda.current_device()) \
            if DEVICE == "cuda" else torch.device("cpu")
        arch, over, _, _ = SERVE[key]
        fed = None if shape is None else \
            torch.load(OUT / f"{key}_single.pt")["fed"]
        try:
            res = _serve(torch, _config(arch, **over), mesh, dev, fed)
        finally:
            if mesh is not None:
                close_train_mesh()
        whole = {k: res.pop(k) for k in ("prefill_logits", "logits",
                                          "picks", "fed")}
        if rank == 0:
            torch.save(whole, OUT / f"{run}.pt")
        res["layers"] = _config(arch, **over).n_layers
    else:
        mesh = None
        if shape is not None:
            mesh = init_train_mesh(shape, device=DEVICE,
                                   init_method=f"tcp://localhost:{port}",
                                   world_size=world, rank=rank)
        dev = torch.device(DEVICE, torch.cuda.current_device()) \
            if DEVICE == "cuda" else torch.device("cpu")
        keep = True
        if part == "c":
            cfg = _config("gemma_7b")
        else:
            _, arch, over, _, gate = CASES[key]
            cfg = _config(arch, **over)
            keep = gate == "f32"
        try:
            res = _train(torch, cfg, mesh, dev, keep_params=keep,
                         perturb=CONTROL_EPS * (mesh_name == "control"),
                         rows=ROWS.get(key, (BATCH, SEQ)))
        finally:
            if mesh is not None:
                close_train_mesh()
        res["layers"] = cfg.n_layers
    params = res.pop("params", None)
    (OUT / f"{run}.rank{rank}.json").write_text(json.dumps(res))
    if rank == 0 and params is not None:
        torch.save([p.cpu() for p in params], OUT / f"{run}.pt")


def fake_census_main(run: str) -> None:
    """The step of mesh run `run` (part (a)) counted in this process
    alone: rank 0 of a fake mesh of the run's shape and DEVICE's type,
    the model, optimizer state and rank 0's rows as meta tensors, one
    step under `CollectiveCensus` (`cells.fake_census`, as the dry-run
    counts a cell).  Writes OUT/<run>.fake.json."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import fake_census
    from repro_torch.launch.mesh import TRAIN_AXES

    key, mesh_name = run.rsplit("_", 1)
    shape = tuple(int(n) for n in mesh_name.split("x"))
    if key in SERVE:
        arch, over, _, _ = SERVE[key]
        cell = ShapeConfig(run, SERVE_PROMPT + SERVE_STEPS, SERVE_BATCH,
                           "decode")
    else:
        _, arch, over, _, _ = CASES[key]
        cell = ShapeConfig(run, SEQ, BATCH, "train")
    t0 = now()
    census = fake_census(_config(arch, **over), cell,
                         dict(zip(TRAIN_AXES, shape)), _tcfg(), DEVICE)
    (OUT / f"{run}.fake.json").write_text(json.dumps(
        {"census": census, "seconds": now() - t0}))


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


def _spawn(run: str, world: int, src: str) -> tuple[list, str]:
    """Run `run` as `world` processes on the package under `src`: (the
    exit codes, the log tail of the first rank that failed by itself,
    not a killed one, or "")."""
    port = _free_port()
    procs = []
    for r in range(world):
        log = open(OUT / f"{run}.rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-of", run,
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--src", src],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=src,
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
    tail = (OUT / f"{run}.rank{failed[0][1]}.log").read_text()[-4000:] \
        if failed else ""
    return rcs, tail


def spawn(run: str, world: int) -> list[dict]:
    """Run `run` as `world` processes; every rank's summary."""
    t0 = now()
    rcs, tail = _spawn(run, world, str(ROOT / "src"))
    if tail:
        print(tail, file=sys.stderr, flush=True)
        check(False, f"{run}: ranks exited {rcs}")
    emit({"phase": "spawned", "run": run, "world": world,
          "seconds": now() - t0})
    return [json.loads((OUT / f"{run}.rank{r}.json").read_text())
            for r in range(world)]


def parent_run(run: str, world: int) -> dict:
    """`run` again on the package under PARENT_SRC (its kernels copied
    from this build: the same sources give the same library names):
    each card's peak GB and rank 0's steps, or the last line the first
    failed rank printed.  Not gated."""
    import shutil

    built = ROOT / "build" / "repro_torch_kernels"
    if built.exists():
        shutil.copytree(built, Path(PARENT_SRC).parent / "build"
                        / "repro_torch_kernels", dirs_exist_ok=True)
    t0 = now()
    rcs, tail = _spawn(run, world, PARENT_SRC)
    line = {"phase": f"{run}_parent", "src": PARENT_SRC, "exit_codes": rcs,
            "seconds": now() - t0}
    if tail:
        line["error"] = [ln for ln in tail.splitlines() if ln.strip()][-1]
    else:
        ranks = [json.loads((OUT / f"{run}.rank{r}.json").read_text())
                 for r in range(world)]
        line.update(_summary(run, ranks, ranks[0]["layers"]))
        line["phase"] = f"{run}_parent"
    return line


def fake_census(run: str) -> dict:
    """`fake_census_main(run)` in a fresh process: its census and
    seconds."""
    with open(OUT / f"{run}.fake.log", "w") as log:
        r = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--fake-census",
             run], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            timeout=RANK_TIMEOUT_S)
    if r.returncode:
        print((OUT / f"{run}.fake.log").read_text()[-4000:],
              file=sys.stderr, flush=True)
        check(False, f"{run}: the fake-mesh census exited {r.returncode}")
    return json.loads((OUT / f"{run}.fake.json").read_text())


def _check_launches(run: str, ranks: list[dict], calls: int,
                    variant: str = "wgmma") -> None:
    """Every rank's every step: 2 forward launches an attention call
    (remat) and 1 backward, all on `variant` (the flash kernels' pick
    for the compute type: "simt" for float32, "wgmma" for bfloat16)."""
    want = [{v: n * (v == variant) for v in ("wgmma", "simt")}
            for n in (2 * calls, calls)]
    for r, res in enumerate(ranks):
        check(all(step == want for step in res["launches"]),
              f"{run}: rank {r} flash launches a step {res['launches']}, "
              f"expected {want}")


def _summary(run: str, ranks: list[dict], layers: int) -> dict:
    r0 = ranks[0]
    warm = r0["step_s"][1:] or r0["step_s"]
    step_s = statistics.median(warm)
    batch, seq = ROWS.get(run.rsplit("_", 1)[0], (BATCH, SEQ))
    return {"phase": run, "layers": layers, "rows": [batch, seq],
            "losses": r0["losses"],
            "grad_norms": r0.get("grad_norms"), "step_s": r0["step_s"],
            "step_ms_median_warm": step_s * 1e3,
            "tokens_per_s": batch * seq / step_s,
            "peak_gb_per_card": [r["peak_bytes"] / 1e9 for r in ranks],
            "census_rank0": r0.get("census"),
            "census_total_gb_per_card":
                [r["census"]["total"] / 1e9 for r in ranks if "census" in r],
            "init_s": r0.get("init_s")}


def run_case(key: str) -> None:
    """The runs of `CASES[key]`: the one-card run (unless the gate is
    "finite"), then each mesh, gated as the case says; every run's
    flash launches and census gated, its summary printed."""
    import numpy as np
    import torch

    _, arch, over, meshes, gate = CASES[key]
    var = "simt" if _config(arch, **over).compute_dtype == "float32" \
        else "wgmma"
    single = None
    if gate != "finite":
        single = spawn(f"{key}_single", 1)
        _check_launches(f"{key}_single", single, single[0]["calls"], var)
        emit(_summary(f"{key}_single", single, single[0]["layers"]))
    if gate == "bf16":
        control = spawn(f"{key}_control", 1)
        _check_launches(f"{key}_control", control, control[0]["calls"], var)
        # The steps one card reproduces: each up to the first whose
        # control moves further than the gate.
        horizon = 0
        for a, b in zip(control[0]["losses"], single[0]["losses"]):
            if abs(a - b) > LOSS_BF16 * abs(b):
                break
            horizon += 1
        line = _summary(f"{key}_control", control, control[0]["layers"])
        line.update(control_eps=CONTROL_EPS, gated_steps=horizon,
                    rel_loss_diff=[abs(a - b) / abs(b) for a, b in zip(
                        control[0]["losses"], single[0]["losses"])])
        emit(line)
    want = torch.load(OUT / f"{key}_single.pt") if gate == "f32" else None
    for shape in meshes:
        run = f"{key}_" + "x".join(map(str, shape))
        ranks = spawn(run, math.prod(shape))
        _check_launches(run, ranks, ranks[0]["calls"], var)
        for r in ranks:
            check(all(x == x and abs(x) < float("inf")
                      for x in r["losses"]),
                  f"{run}: non-finite losses {r['losses']}")
        check(all(r["census"]["total"] > 0 for r in ranks),
              f"{run}: a rank's census counted no collective")
        line = _summary(run, ranks, ranks[0]["layers"])
        if key.startswith("a_"):
            fake = fake_census(run)
            line.update(census_fake_mesh=fake["census"],
                        census_fake_mesh_s=fake["seconds"])
            check(fake["census"] == ranks[0]["census"],
                  f"{run}: the fake mesh's census {fake['census']} is not "
                  f"rank 0's {ranks[0]['census']}")
        if single is not None:
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["losses"], single[0]["losses"])]
            line.update(losses_single=single[0]["losses"],
                        max_rel_loss_diff=max(rel))
        if gate == "f32":
            np.testing.assert_allclose(ranks[0]["losses"],
                                       single[0]["losses"], **LOSS_F32)
            got = torch.load(OUT / f"{run}.pt")
            worst = 0.0
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, **PARAMS_F32)
                worst = max(worst, (g - w).abs().max().item())
            line.update(max_abs_param_diff=worst)
            del got
            (OUT / f"{run}.pt").unlink()
        elif gate == "bf16":
            line.update(gated_steps=horizon, rel_loss_diff=rel)
            check(horizon > 0 and max(rel[:horizon]) <= LOSS_BF16,
                  f"{run}: losses {ranks[0]['losses']} against one "
                  f"card's {single[0]['losses']}, rtol {LOSS_BF16} over "
                  f"the first {horizon} steps")
        emit(line)
        if key == "t" and PARENT_SRC:
            emit(parent_run(run, math.prod(shape)))
    if gate == "f32":
        (OUT / f"{key}_single.pt").unlink()


def run_serve(key: str) -> None:
    """Part (s) for `SERVE[key]`: one card greedy, then each mesh fed
    its picks; gated as the module says."""
    import torch

    arch, over, meshes, share = SERVE[key]
    cfg = _config(arch, **over)
    var = "simt" if cfg.compute_dtype == "float32" else "wgmma"
    runs = [f"{key}_single"] + [f"{key}_" + "x".join(map(str, m))
                                for m in meshes]
    want = None
    for run, shape in zip(runs, (None,) + meshes):
        ranks = spawn(run, 1 if shape is None else math.prod(shape))
        got = torch.load(OUT / f"{run}.pt")
        for r, res in enumerate(ranks):
            check(res["prefill_launches"] == [
                {v: res["calls"] * (v == var) for v in ("wgmma", "simt")},
                {"wgmma": 0, "simt": 0}]
                and res["decode_launches"] == [{"wgmma": 0, "simt": 0}] * 2,
                f"{run}: rank {r} flash launches {res['prefill_launches']}"
                f" in the prefill, {res['decode_launches']} decoding")
        r0 = ranks[0]
        line = {"phase": run, "arch": arch, "layers": r0["layers"],
                "prefill_s": [r["prefill_s"] for r in ranks],
                "prefill_launches_rank": r0["prefill_launches"],
                "decode_ms_per_token": [ms / SERVE_BATCH
                                        for ms in r0["step_ms"]],
                "decode_ms_median": statistics.median(r0["step_ms"][1:]),
                "peak_gb_per_card": [r["peak_bytes"] / 1e9 for r in ranks],
                "census_rank0": r0.get("census")}
        if want is None:
            want = got
        else:
            errs = [(g - w).abs().max().item() / w.abs().max().item()
                    for g, w in zip([got["prefill_logits"]] + got["logits"],
                                    [want["prefill_logits"]]
                                    + want["logits"])]
            # A pick may differ from one card's only where one card's
            # two largest logits are within twice the step's largest
            # difference (bf16; float32 gates every pick).
            ties, bad = 0, []
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
                top = w[:, -1].topk(2, dim=-1).values
                near = top[:, 0] - top[:, 1] <= 2 * (g - w).abs().max()
                flip = got["picks"][:, i] != want["picks"][:, i]
                ties += int((flip & near).sum())
                if (flip & ~near).any() or (share <= 1e-5 and flip.any()):
                    bad.append(i)
            line.update(max_rel_logits_err=max(errs), bound=share,
                        picks_flipped_at_near_ties=ties, picks_bad_steps=bad,
                        picks_equal=bool(torch.equal(got["picks"],
                                                     want["picks"])))
            fake = fake_census(run)
            line.update(census_fake_mesh=fake["census"],
                        census_fake_mesh_s=fake["seconds"])
            emit(line)
            check(not bad, f"{run}: picks at steps {bad} differ from one "
                  f"card's {want['picks'].tolist()}: "
                  f"{got['picks'].tolist()}")
            check(max(errs) <= share, f"{run}: logits {max(errs):.3g} of "
                  f"one card's largest, bound {share}")
            check(fake["census"] == r0["census"],
                  f"{run}: the fake mesh's census {fake['census']} is not "
                  f"rank 0's {r0['census']}")
            (OUT / f"{run}.pt").unlink()
            continue
        emit(line)
    (OUT / f"{key}_single.pt").unlink()


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
    a_archs = [k[2:] for k in CASES if k.startswith("a_")]
    ap.add_argument("--runs", default="a,b,c,d,e,f,g,h,t,s")
    ap.add_argument("--archs", default=",".join(a_archs),
                    help="part (a)'s and (s)'s models, of "
                    + ", ".join(a_archs))
    ap.add_argument("--rank-of", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--fake-census", help=argparse.SUPPRESS)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--skip", default="",
                    help="run keys of the parts to leave out (`CASES`)")
    ap.add_argument("--parent-src", default=None,
                    help="an older package's src/ that part (t) also "
                    "runs on, not gated")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    global PARENT_SRC
    PARENT_SRC = args.parent_src and str(Path(args.parent_src).resolve())
    if args.rank_of:
        rank_main(args.rank_of, args.rank, args.world, args.port)
        return 0
    if args.fake_census:
        fake_census_main(args.fake_census)
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
    check(set(archs) <= set(a_archs), f"--archs: {archs}, of {a_archs}")

    def cases(keys):
        return lambda: [run_case(k) for k in keys]

    parts = {"a": cases([f"a_{a}" for a in archs]), "b": part_b,
             "c": part_c}
    skip = set(args.skip.split(",")) - {""}
    check(skip <= set(CASES), f"--skip: {sorted(skip)}, of {list(CASES)}")
    parts.update({p: cases([k for k, c in CASES.items()
                            if c[0] == p and k not in skip])
                  for p in "defght"})
    parts["s"] = lambda: [run_serve(k) for k in SERVE
                          if SERVE[k][0] in archs]
    failed = []
    for name in args.runs.split(","):
        t1 = now()
        try:
            parts[name]()
        except AssertionError as e:     # a gate: the other parts still run
            failed.append(name)
            emit({"phase": f"part_{name}", "failed": str(e)[-2000:],
                  "seconds": now() - t1})
            continue
        emit({"phase": f"part_{name}", "seconds": now() - t1})
    emit({"phase": "total", "seconds": now() - t0, "failed_parts": failed})
    if DEVICE == "cuda":
        print(smi_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
