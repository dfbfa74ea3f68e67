"""Device resolution for the port's entry points.

Every entry point (`dosa_search`, `run_request`, `tune_matmul_blocks`,
`default_blocks`, `tuned_matmul`) takes an explicit ``device`` and
defaults to ``"cuda"``: the port runs on the card unless the caller
asks for the CPU.  A CUDA request on a machine without a usable GPU
raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` as a `torch.device` with its index filled in, checked
    to be usable: a CUDA device needs `torch.cuda.is_available()`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return canonical_device(dev)


def canonical_device(device) -> torch.device:
    """`device` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that per-device caches keyed on it agree with `tensor.device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
