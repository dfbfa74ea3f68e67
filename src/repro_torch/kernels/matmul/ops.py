"""Public matmul entry point: DOSA-tuned default block shapes,
divisor-safe block rounding, then the kernel wrapper.  The port of
`repro.kernels.matmul.ops`."""
from __future__ import annotations

import torch

from ...core.autotune import round_block  # DOSA Sec. 5.3.2-style rounding
from ...device import DEFAULT_DEVICE
from .matmul import matmul
from .ref import matmul_ref  # noqa: F401  (public kernel surface)


def tuned_blocks(m: int, k: int, n: int,
                 blocks: tuple[int, int, int] | None = None,
                 device=DEFAULT_DEVICE) -> tuple[int, int, int]:
    """The ``(bm, bk, bn)`` `tuned_matmul` hands the kernel wrapper:
    `default_blocks` (tuned on `device`) or the caller's blocks,
    snapped to divisors of the problem.

    `default_blocks` returns ``(bm, bn, bk)``, and the reference's
    wrapper reads it as ``(bm, bk, bn)``, so the tuned bk and bn swap
    places.  The result is unaffected (the wrapper only checks that
    blocks divide the problem); the port repeats the reading for
    parity."""
    if blocks is None:
        from ...core.autotune import default_blocks
        blocks = default_blocks(m, n, k, device=device)
    bm = round_block(m, blocks[0])
    bk = round_block(k, blocks[1])
    bn = round_block(n, blocks[2])
    return bm, bk, bn


def tuned_matmul(x: torch.Tensor, y: torch.Tensor,
                 blocks: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Matmul through the kernel wrapper with (bm, bk, bn) chosen by the
    DOSA autotuner (or caller-supplied).  Runs where the operands live:
    on the card the tuner and the CUDA kernel, on the CPU both through
    their plain versions."""
    m, k = x.shape
    n = y.shape[1]
    bm, bk, bn = tuned_blocks(m, k, n, blocks, device=x.device)
    return matmul(x, y, bm=bm, bk=bk, bn=bn)
