"""Is Mamba-2's 3-step float32 training on one card sensitive to
float32 rounding?  On the card, from the root of a checkout:

    python3 tests/torch_mamba2_chaos_card.py

For 48, 16 and 4 layers at full width it runs chip_dist_train.py's
part (e) step on one card (seed 0, 8 x 512, AdamW lr 3e-4, warmup 20)
with the parameters as drawn, twice, and scaled by (1 + 1e-7 N(0, 1))
after the draw, and prints each run's losses and gradient norms and the
largest parameter difference after 3 steps (a JSON line a depth).
Torch only; under a minute on one H100.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch_rows  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig, tree_leaves  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          init_train_state, make_train_step)

EPS = 1e-7
DEPTHS = (48, 16, 4)


def run(layers: int, eps: float) -> tuple:
    """(losses, gradient norms, final parameters) of 3 steps."""
    cfg = dataclasses.replace(get_config("mamba2_1_3b"),
                              compute_dtype="float32", n_layers=layers)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    if eps:
        noise = torch.Generator("cuda").manual_seed(1)
        with torch.no_grad():
            for p in tree_leaves(model.params):
                p.mul_(1 + eps * torch.randn(p.shape, generator=noise,
                                             device="cuda"))
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=20))
    step, _ = make_train_step(model, tcfg)
    params, opt = init_train_state(model, tcfg)
    data = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=512,
                      global_batch=8)
    losses, norms = [], []
    for i in range(3):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in make_batch_rows(data, i, 0, 8).items()}
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    final = [p.detach().clone() for p in tree_leaves(params)]
    del model, params, opt, step
    torch.cuda.empty_cache()
    return losses, norms, final


def largest_diff(a: list, b: list) -> float:
    return max((p - q).abs().max().item() for p, q in zip(a, b))


def main() -> None:
    for layers in DEPTHS:
        t0 = time.perf_counter()
        a, b, c = run(layers, 0.0), run(layers, 0.0), run(layers, EPS)
        print(json.dumps({
            "layers": layers, "losses": a[0], "losses_again": b[0],
            "losses_perturbed": c[0], "norms": a[1],
            "norms_perturbed": c[1],
            "param_diff_again": largest_diff(a[2], b[2]),
            "param_diff_perturbed": largest_diff(a[2], c[2]),
            "seconds": time.perf_counter() - t0}), flush=True)
        del a, b, c


if __name__ == "__main__":
    main()
