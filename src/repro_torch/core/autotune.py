"""DOSA one-loop gradient search over matmul block shapes, on torch.

The PyTorch port of `repro.core.autotune`: the
paper's loop on the TPU v5e block-cost model (`tpu_model`) —
log-domain block sizes -> Adam -> divisor rounding (Sec. 5.3.2) ->
pick the best rounded candidate by the analytical model.  Hardware is
fixed silicon, so mapping-first hardware inference becomes the VMEM
feasibility penalty.  It runs on the device the caller names (the card
by default).  It tunes the matmul's blocks only: the reference's
docstring also names a `tune_flash_blocks`, which it never defines, and
the port has no flash-attention tuner either.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .arch import TPU_V5E, TPUTarget
from .model import relu
from .problem import divisors
from .tpu_model import matmul_latency, vmem_footprint, vmem_penalty


def round_block(dim: int, target: float) -> int:
    """Nearest divisor of `dim` to `target` (Sec. 5.3.2 rounding)."""
    best, bestd = 1, abs(1 - target)
    for d in divisors(int(dim)):
        if abs(d - target) < bestd:
            best, bestd = d, abs(d - target)
    return best


@dataclasses.dataclass
class TuneResult:
    blocks: tuple[int, int, int]
    latency_s: float
    compute_s: float
    memory_s: float
    vmem_bytes: float
    history: list


def tune_matmul_blocks(m: int, n: int, k: int, dtype_bytes: float = 2.0,
                       steps: int = 300, lr: float = 0.05,
                       penalty: float = 100.0, seed: int = 0,
                       target: TPUTarget = TPU_V5E,
                       device=DEFAULT_DEVICE) -> TuneResult:
    """One-loop GD over log(bm, bn, bk) on `device`; returns the
    rounded best.  `seed` is accepted for the reference's signature:
    the search draws no random numbers."""
    dev = resolve_device(device)

    def loss(theta):
        b = torch.exp(theta)
        bm, bn, bk = b[0], b[1], b[2]
        lat, _ = matmul_latency(m, n, k, bm, bn, bk, dtype_bytes, target)
        pen = vmem_penalty(bm, bn, bk, dtype_bytes, target)
        # block must not exceed the problem
        over = (relu(bm / m - 1.0) + relu(bn / n - 1.0)
                + relu(bk / k - 1.0))
        return torch.log(lat) + penalty * (pen + over)

    theta = torch.log(torch.tensor(
        [min(m, 256.0), min(n, 256.0), min(k, 512.0)],
        dtype=torch.float32, device=dev))
    m_t = torch.zeros(3, device=dev)
    v_t = torch.zeros(3, device=dev)
    history = []
    best = None
    for t in range(1, steps + 1):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(th), th)
        with torch.no_grad():
            m_t = 0.9 * m_t + 0.1 * g
            v_t = 0.999 * v_t + 0.001 * g * g
            theta = theta - lr * (m_t / (1 - 0.9 ** t)) / (
                torch.sqrt(v_t / (1 - 0.999 ** t)) + 1e-8)
        if t % 50 == 0 or t == steps:
            cand = _round_and_eval(m, n, k,
                                   np.exp(theta.cpu().numpy()),
                                   dtype_bytes, target, dev)
            history.append((t, cand[1]))
            if best is None or cand[1] < best[1]:
                best = cand
    blocks, lat, aux = best
    return TuneResult(blocks=blocks, latency_s=lat,
                      compute_s=float(aux["compute_s"]),
                      memory_s=float(aux["memory_s"]),
                      vmem_bytes=float(_fp(blocks, dtype_bytes, dev)),
                      history=history)


def _blocks_tensors(blocks, device):
    """(bm, bn, bk) float32 tensors from a list of integer triples."""
    b = torch.tensor(blocks, dtype=torch.float32, device=device)
    return b[..., 0], b[..., 1], b[..., 2]


def _fp(blocks, dtype_bytes, device):
    bm, bn, bk = _blocks_tensors(blocks, device)
    return vmem_footprint(bm, bn, bk, dtype_bytes).item()


def _round_and_eval(m, n, k, b_cont, dtype_bytes, target, device):
    """Round continuous blocks to divisors; prefer MXU-aligned
    candidates (multiples of (8,128) within the divisor set).  All
    candidates are scored in one batched call; the first of the
    fastest VMEM-feasible ones wins, as in the reference's loop."""
    grid = [(bm, bn, bk)
            for bm in _aligned_divisors(m, b_cont[0], 8)
            for bn in _aligned_divisors(n, b_cont[1], 128)
            for bk in _aligned_divisors(k, b_cont[2], 128)]
    lat, aux, pen = _score(m, n, k, grid, dtype_bytes, target, device)
    cands = [(grid[i], float(lat[i]),
              {kk: float(vv[i]) for kk, vv in aux.items()})
             for i in range(len(grid)) if not pen[i] > 0]
    if not cands:
        b = (round_block(m, b_cont[0]), round_block(n, b_cont[1]),
             round_block(k, b_cont[2]))
        lat, aux, _ = _score(m, n, k, [b], dtype_bytes, target, device)
        return b, float(lat[0]), {kk: float(vv[0])
                                  for kk, vv in aux.items()}
    return min(cands, key=lambda c: c[1])


def _score(m, n, k, blocks, dtype_bytes, target, device):
    """Latency, aux terms and VMEM penalty of candidate blocks, as numpy
    float32 arrays."""
    bm, bn, bk = _blocks_tensors(blocks, device)
    with torch.no_grad():
        lat, aux = matmul_latency(m, n, k, bm, bn, bk, dtype_bytes, target)
        pen = vmem_penalty(bm, bn, bk, dtype_bytes, target)
    return (lat.cpu().numpy(),
            {kk: vv.cpu().numpy() for kk, vv in aux.items()},
            pen.cpu().numpy())


def _aligned_divisors(dim: int, center: float, align: int,
                      width: float = 4.0) -> list[int]:
    """Divisors of dim within [center/width, center*width], preferring
    `align` multiples; always non-empty."""
    divs = divisors(int(dim))
    window = [d for d in divs if center / width <= d <= center * width]
    aligned = [d for d in window if d % align == 0 or d == dim]
    out = aligned or window or [round_block(dim, center)]
    return sorted(set(out))[:8]


@functools.lru_cache(maxsize=256)
def _default_blocks(m: int, n: int, k: int,
                    device: str) -> tuple[int, int, int]:
    return tune_matmul_blocks(m, n, k, steps=120, device=device).blocks


def default_blocks(m: int, n: int, k: int,
                   device=DEFAULT_DEVICE) -> tuple[int, int, int]:
    """Cached DOSA-tuned blocks ``(bm, bn, bk)`` for the kernel
    wrappers, tuned on `device`."""
    return _default_blocks(int(m), int(n), int(k),
                           str(resolve_device(device)))
