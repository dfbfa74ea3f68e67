"""End-to-end driver on the PyTorch port: train a small qwen3-family
model for a few hundred steps on synthetic data, with checkpoint and
restart exercised mid-run.  The production-size path is the same code
via `python -m repro_torch.launch.train --arch qwen3_0_6b`.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
        [--ckpt-dir DIR] [--device cuda]

The counterpart of examples/train_lm.py, on the card unless asked
otherwise.
"""
import argparse
import dataclasses
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm import build_model
from repro_torch.runtime.fault_tolerance import (DriverConfig,
                                                 train_with_recovery)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--ckpt-dir", default=None,
                help="checkpoint directory (default: a fresh temporary "
                     "one, removed at the end)")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)
ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm_")
shutil.rmtree(ckpt_dir, ignore_errors=True)

# ~10M-param qwen3-family config (trainable in minutes; the 0.6B and
# larger assigned configs run the same code).
cfg = dataclasses.replace(
    get_config("qwen3_0_6b"), n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=768, vocab_size=4096,
    compute_dtype="float32")
model = build_model(cfg, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
params = model.params
n = sum(p.numel() for p in model.parameters())
print(f"model: {n/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model}) on "
      f"{dev}")

tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=30, b2=0.98))
train_step, init_opt = make_train_step(model, tcfg)
opt_state = init_opt(tcfg.opt, params)
data_cfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=256,
                      global_batch=4)

# inject one simulated node failure to demonstrate recovery
fired = {"done": False}


def fault(step):
    if step == args.steps // 2 and not fired["done"]:
        fired["done"] = True
        raise RuntimeError("injected failure (simulated preemption)")


params, opt_state, report = train_with_recovery(
    train_step, params, opt_state, data_cfg,
    DriverConfig(total_steps=args.steps, ckpt_every=50,
                 ckpt_dir=ckpt_dir, log_every=50),
    fault_hook=fault)
if args.ckpt_dir is None:
    shutil.rmtree(ckpt_dir, ignore_errors=True)

first, last = report.losses[0], float(np.mean(report.losses[-20:]))
print(f"\nloss {first:.3f} -> {last:.3f} over {report.steps_run} steps "
      f"({report.restarts} restart(s), recovered from checkpoint)")
if not last < first or report.restarts != 1:
    raise SystemExit("the loss did not fall, or the run did not restart "
                     "once")
print("OK")
