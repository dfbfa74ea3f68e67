"""Serving entry point: batched greedy decode of random prompts on the
port's LM (the port of `repro.launch.serve`, same flags, same request
flow, same output lines).

    python -m repro_torch.launch.serve --arch qwen3_0_6b --reduced \
        --batch 4 --prompt-len 16 --gen 32 [--ckpt-dir ckpts] \
        [--device cuda]

It runs on the card unless `--device cpu` is given.  With `--ckpt-dir`
the parameters come from the newest checkpoint there (`state["params"]`
of a training checkpoint of either package, as the reference reads it)
instead of the seed.  The clock is injected: `main` takes it as an
argument, and only the `__main__` block below names
`time.perf_counter`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt
from ..configs import get_config
from ..convert import lm_params_from_numpy
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.lm import build_model
from ..serve.serve_step import greedy_decode


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def prompts_for(args: argparse.Namespace, vocab_size: int) -> torch.Tensor:
    """The `args.batch` random prompts of `args.prompt_len` tokens, from
    `args.seed` (numpy, as the reference draws them), on the CPU."""
    rng = np.random.default_rng(args.seed)
    return torch.from_numpy(
        rng.integers(1, vocab_size, (args.batch, args.prompt_len)))


def decode(model, prompts: torch.Tensor, gen: int, clock,
           image_embeds: torch.Tensor | None = None):
    """The serve loop: `greedy_decode` of `prompts` (B, P) on the
    model's device, `gen` tokens generated (with `image_embeds` for the
    VLM).  Returns (tokens (B, P + gen) on the CPU, seconds of the loop
    by `clock`, the tokens read back included)."""
    t0 = clock()
    seq = greedy_decode(model, prompts, gen, device=model.device,
                        image_embeds=image_embeds).cpu()
    return seq, clock() - t0


def load_model(args: argparse.Namespace, log=print):
    """The model `args` name, on `args.device`: built from `args.seed`,
    or with the parameters of the newest checkpoint in `args.ckpt_dir`
    (logging the step)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.ckpt_dir:
        step, state = ckpt.restore(args.ckpt_dir)
        model = lm_params_from_numpy(cfg, state["params"], device=dev)
        log(f"[serve] restored step {step} from {args.ckpt_dir}")
        return model
    gen = torch.Generator(dev).manual_seed(args.seed)
    return build_model(cfg, device=dev, generator=gen)


def run(args: argparse.Namespace, clock, log=print):
    """`load_model`, then `decode` `args.batch` random prompts.  Returns
    (tokens (B, prompt_len + gen) on the CPU, seconds of the decode
    loop by `clock`)."""
    model = load_model(args, log)
    prompts = prompts_for(args, model.cfg.vocab_size).to(model.device)
    return decode(model, prompts, args.gen, clock)


def main(argv=None, *, clock) -> None:
    args = parse_args(argv)
    seq, dt = run(args, clock)
    max_seq = seq.shape[1]
    print(f"[serve] {args.batch} seqs x {max_seq} tokens in {dt:.1f}s "
          f"({args.batch*max_seq/dt:.1f} tok/s)")
    print("[serve] sample:", seq[0, :32].tolist())


if __name__ == "__main__":
    main(clock=time.perf_counter)
