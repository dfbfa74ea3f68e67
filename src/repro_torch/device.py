"""Device resolution for the port's entry points.

Every entry point (`dosa_search`, `run_request`, `tune_matmul_blocks`,
`default_blocks`, `tuned_matmul`) takes an explicit ``device`` and
defaults to ``"cuda"``: the port runs on the card unless the caller
asks for the CPU.  A CUDA request on a machine without a usable GPU
raises; nothing falls back to the CPU.

The co-search entry points (`dosa_search`, `fleet_search`,
`run_request`, the service and its HTTP server) also take a sequence
of devices: the population ("pop") mesh its shards run on
(`resolve_devices`, `launch.mesh.make_pop_mesh`).

Training over several cards runs one process a card
(`launch.mesh.init_train_mesh`); `rank_device` names the card of a
process.
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


def resolve_devices(device=DEFAULT_DEVICE) -> tuple[torch.device, ...]:
    """The devices a co-search entry point's `device` names, in order:
    a sequence gives its entries (a device may repeat, so one card or
    the CPU can hold several shards), a single device itself, as
    `resolve_device` resolves it (``"cuda"`` is the current card).  A
    mesh over several cards is opt-in: the caller names them."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device sequence names no device")
        return tuple(resolve_device(d) for d in device)
    return (resolve_device(device),)


def rank_device(device_type: str, rank: int, local_rank: int | None = None
                ) -> torch.device:
    """The device of process `rank` in a training mesh: the CPU for
    ``"cpu"``; for ``"cuda"`` the card of its local rank (`local_rank`,
    as torchrun's ``LOCAL_RANK`` gives it, else `rank` modulo the
    visible cards).  A CUDA request without a usable card raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a training mesh runs on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    resolve_device("cuda")
    n = torch.cuda.device_count()
    index = rank % n if local_rank is None else local_rank
    if not 0 <= index < n:
        raise RuntimeError(f"local rank {index} has no card: {n} visible")
    return torch.device("cuda", index)
