"""Serve a small model with batched greedy decoding through the
KV-cache serve path of the PyTorch port (one decode step per token).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cuda]

The counterpart of examples/serve_lm.py, on the card unless asked
otherwise.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import build_model
from repro_torch.serve.serve_step import make_serve_step

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)

cfg = get_config("qwen3_0_6b", reduced=True)
cfg = dataclasses.replace(cfg, compute_dtype="float32")
model = build_model(cfg, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))

batch, prompt_len, gen = 4, 8, 24
rng = np.random.default_rng(0)
prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (batch, prompt_len))).to(dev)
max_seq = prompt_len + gen
cache = model.init_cache(batch, max_seq)
step = make_serve_step(model)

tok = prompts[:, :1]
out = [tok]
t0 = time.perf_counter()
for pos in range(max_seq - 1):
    nxt, cache = step(cache, tok, pos)
    tok = prompts[:, pos + 1:pos + 2] if pos + 1 < prompt_len else nxt
    out.append(tok)
seq = torch.cat(out, dim=1).cpu().numpy()
dt = time.perf_counter() - t0

print(f"decoded {batch} x {max_seq} tokens in {dt:.1f}s "
      f"({batch*max_seq/dt:.0f} tok/s, {dev})")
for i in range(batch):
    print(f"  seq{i}: prompt={seq[i,:prompt_len].tolist()} "
          f"gen={seq[i,prompt_len:].tolist()}")
if seq.shape != (batch, max_seq) or not ((seq >= 0).all()
                                         and (seq < cfg.vocab_size).all()):
    raise SystemExit(f"bad tokens: shape {seq.shape}")
print("OK")
