"""Serving entry point: batched greedy decode of random prompts on the
port's LM (the port of `repro.launch.serve`, same flags, same request
flow, same output lines).

    python -m repro_torch.launch.serve --arch qwen3_0_6b --reduced \
        --batch 4 --prompt-len 16 --gen 32 [--device cuda]

It runs on the card unless `--device cpu` is given.  The clock is
injected: `main` takes it as an argument, and only the `__main__` block
below names `time.perf_counter`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..models.lm import build_model
from ..serve.serve_step import make_serve_step


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


def run(args: argparse.Namespace, clock):
    """Build the model from `args.seed`, then decode `args.batch`
    random prompts: step through each prompt, then generate greedily.
    Returns (tokens (B, prompt_len + gen) on the CPU, seconds of the
    decode loop by `clock`, the tokens read back included)."""
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpoint restore waits for the checkpoint "
            "slice of the port (ROADMAP queue 1 item 6)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size,
                     (args.batch, args.prompt_len))).to(dev)
    max_seq = args.prompt_len + args.gen
    cache = model.init_cache(args.batch, max_seq)
    step_fn = make_serve_step(model)

    tok = prompts[:, :1]
    out = [tok]
    t0 = clock()
    for pos in range(max_seq - 1):
        nxt, cache = step_fn(cache, tok, pos)
        tok = (prompts[:, pos + 1:pos + 2]
               if pos + 1 < args.prompt_len else nxt)
        out.append(tok)
    seq = torch.cat(out, dim=1).cpu()
    return seq, clock() - t0


def main(argv=None, *, clock) -> None:
    args = parse_args(argv)
    seq, dt = run(args, clock)
    max_seq = seq.shape[1]
    print(f"[serve] {args.batch} seqs x {max_seq} tokens in {dt:.1f}s "
          f"({args.batch*max_seq/dt:.1f} tok/s)")
    print("[serve] sample:", seq[0, :32].tolist())


if __name__ == "__main__":
    main(clock=time.perf_counter)
