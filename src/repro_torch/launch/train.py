"""Training entry point: the port of `repro.launch.train`, same flags
plus `--device`.

    python -m repro_torch.launch.train --arch qwen3_0_6b --steps 200 \
        --batch 8 --seq 512 [--reduced] [--ckpt-dir ckpts] [--device cuda]

It trains on the card unless `--device cpu` is given (there the flash
attention runs its plain versions).  Fault tolerance (checkpoint/restart,
straggler logging) comes from `runtime.fault_tolerance`; a run resumes
from the newest checkpoint in `--ckpt-dir`.
"""
from __future__ import annotations

import argparse
from typing import Callable

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.lm import build_model
from ..runtime.fault_tolerance import DriverConfig, train_with_recovery
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the architecture")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        fault_hook: Callable[[int], None] | None = None,
        log: Callable[[str], None] = print):
    """Build the model on `args.device` from `args.seed` and train it
    through `train_with_recovery`.  Returns (model, report)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(args.seed))
    params = model.params
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
        f"{n_params/1e6:.1f}M params, on {dev}")

    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=20),
                       microbatches=args.microbatches)
    train_step, init_opt = make_train_step(model, tcfg)
    opt_state = init_opt(tcfg.opt, params)

    data_cfg = DataConfig(seed=args.seed, vocab_size=cfg.vocab_size,
                          seq_len=args.seq, global_batch=args.batch,
                          modality=cfg.modality, d_model=cfg.d_model,
                          n_image_tokens=cfg.n_image_tokens)
    dcfg = DriverConfig(total_steps=args.steps,
                        ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir)
    _, _, report = train_with_recovery(train_step, params, opt_state,
                                       data_cfg, dcfg,
                                       fault_hook=fault_hook, log=log)
    return model, report


def main(argv=None) -> None:
    _, report = run(parse_args(argv))
    print(f"[train] done: {report.steps_run} steps, "
          f"{report.restarts} restarts, "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")


if __name__ == "__main__":
    main()
