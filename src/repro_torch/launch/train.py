"""Training entry point: the port of `repro.launch.train`, same flags
plus `--device`.

    python -m repro_torch.launch.train --arch qwen3_0_6b --steps 200 \
        --batch 8 --seq 512 [--reduced] [--ckpt-dir ckpts] [--device cuda]

It trains on the card unless `--device cpu` is given (there the flash
attention runs its plain versions).  Fault tolerance (checkpoint/restart,
straggler logging) comes from `runtime.fault_tolerance`; a run resumes
from the newest checkpoint in `--ckpt-dir`.

With `--mesh POD x DATA x MODEL` it is the reference's "runs under the
production mesh with the shardings from the model's spec tree", in
torch one process a card: each process joins the group
(`launch.mesh.init_train_mesh`: NCCL on cards, gloo on the CPU) and
trains its shards of the model (any family: the MoE's experts and the
SSD's heads over "model"; HuBERT's frames and labels, and the VLM's
image embeddings, a rank's rows of the batch).  `--dist-init`,
`--world-size` and `--rank` default to torchrun's environment, so
either

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh 1x2x2 ...

or one process per rank with `--dist-init tcp://localhost:PORT
--world-size 4 --rank R` runs it.  Without `--mesh` it trains on one
device with no process group.
"""
from __future__ import annotations

import argparse
from typing import Callable

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig
from ..device import DEFAULT_DEVICE, canonical_device, resolve_device
from ..models.lm import build_model
from ..runtime.fault_tolerance import DriverConfig, train_with_recovery
from ..train.optimizer import OptConfig
from ..train.train_step import (TrainConfig, init_train_state,
                                make_train_step)
from .mesh import close_train_mesh, init_train_mesh, parse_mesh


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
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="POD x DATA x MODEL, e.g. 1x2x2: train over that "
                         "mesh, one process a device")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init method (with --mesh)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="processes in the group (torchrun's WORLD_SIZE)")
    ap.add_argument("--rank", type=int, default=None,
                    help="this process's rank (torchrun's RANK)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        fault_hook: Callable[[int], None] | None = None,
        log: Callable[[str], None] = print):
    """Build the model on `args.device` from `args.seed` and train it
    through `train_with_recovery`; with `args.mesh`, this process's
    shards of it over the training mesh (joined here, and left only by
    `main`).  Returns (model, report)."""
    mesh = None
    if args.mesh is not None:
        mesh = init_train_mesh(args.mesh, device=args.device,
                               init_method=args.dist_init,
                               world_size=args.world_size, rank=args.rank)
        dev = canonical_device(mesh.device_type)
    else:
        dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=dev, mesh=mesh,
                        generator=torch.Generator(dev).manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    where = f"{dev}" if mesh is None else \
        f"{'x'.join(map(str, args.mesh))} mesh of {mesh.device_type}"
    if mesh is None or mesh.get_rank() == 0:
        log(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
            f"{n_params/1e6:.1f}M params, on {where}")

    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=20),
                       microbatches=args.microbatches)
    train_step, _ = make_train_step(model, tcfg, mesh)
    params, opt_state = init_train_state(model, tcfg, mesh)

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
    args = parse_args(argv)
    try:
        _, report = run(args)
        if args.mesh is None or torch.distributed.get_rank() == 0:
            print(f"[train] done: {report.steps_run} steps, "
                  f"{report.restarts} restarts, "
                  f"loss {report.losses[0]:.3f} -> "
                  f"{report.losses[-1]:.3f}")
    finally:
        if args.mesh is not None:
            close_train_mesh()


if __name__ == "__main__":
    main()
