"""Device meshes.

Single pod:  (16, 16)      axes ("data", "model")        = 256 devices
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices
Population:  (shards,)     axis  ("pop",)  — co-search population axis

The port of `repro.launch.mesh`.  The production shapes are tables
that hold no devices: the dry-run (`launch.cells`) reads them to divide
each tensor's bytes by the axes its spec names and a step's counts by
the device count.  The population mesh and the host mesh hold real
devices (`DeviceMesh`), named as the co-search entry points name them
(`device.resolve_devices`): a single device is one device (``"cuda"``
the current card), and a sequence may repeat a device, so one card or
the CPU can hold several shards.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..device import DEFAULT_DEVICE, resolve_devices


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_name(mesh: dict[str, int]) -> str:
    """"16x16", "2x16x16": the sizes in axis order."""
    return "x".join(str(n) for n in mesh.values())


def mesh_devices(mesh: dict[str, int]) -> int:
    return math.prod(mesh.values())


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Devices laid out over named axes, row-major: `devices` holds
    them flat, `axis_sizes` the extent of each of `axis_names`."""

    devices: tuple[torch.device, ...]
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_host_mesh(model: int = 1,
                   devices=DEFAULT_DEVICE) -> DeviceMesh:
    """Tiny (1, n // model, model) mesh over the `n` devices named by
    `devices`, axes ("pod", "data", "model")."""
    devs = resolve_devices(devices)
    if model < 1 or len(devs) % model:
        raise ValueError(f"model={model} does not divide the "
                         f"{len(devs)} devices")
    return DeviceMesh(devs, (1, len(devs) // model, model),
                      ("pod", "data", "model"))


@functools.lru_cache(maxsize=None)
def _pop_mesh(devices: tuple[torch.device, ...]) -> DeviceMesh:
    return DeviceMesh(devices, (len(devices),), ("pop",))


def _check_shards(shards: int, n_dev: int) -> None:
    if shards < 1 or shards > n_dev:
        raise ValueError(f"shards={shards} outside 1..{n_dev} "
                         "available devices")


def make_pop_mesh(shards: int, devices=DEFAULT_DEVICE) -> DeviceMesh:
    """1-D mesh over the first `shards` of the devices `devices` names,
    axis "pop" — the co-search engines shard their population /
    fleet-member axis over it.  Cached per (shards, devices), so every
    engine run for the same count closes over ONE mesh object.  The
    population axis may cover a strict subset of the devices (shards
    is a divisor of the population, not of the device count)."""
    devs = resolve_devices(devices)
    _check_shards(shards, len(devs))
    return _pop_mesh(devs[:shards])


def auto_pop_shards(members: int, requested: int | None = None,
                    devices=DEFAULT_DEVICE) -> int:
    """Resolve the population shard count: the member axis must divide
    evenly, so `None` picks the largest divisor of `members` that fits
    the device count (1 on a single device — the unsharded engine
    path).  An explicit request is validated, not adjusted."""
    n_dev = len(resolve_devices(devices))
    if requested is not None:
        _check_shards(requested, n_dev)
        if members % requested:
            raise ValueError(f"shards={requested} does not divide the "
                             f"{members}-member population/chunk evenly")
        return requested
    return max(s for s in range(1, min(members, n_dev) + 1)
               if members % s == 0)
