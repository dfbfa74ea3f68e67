"""Device meshes.

Single pod:  (16, 16)      axes ("data", "model")        = 256 devices
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices
Population:  (shards,)     axis  ("pop",)  — co-search population axis
Training:    (pod, data, model) axes ("pod", "data", "model"), one
             process a card (`init_train_mesh`)
Fake:        a production shape over a fake process group, rank 0 of
             its 256 or 512 ranks (`fake_production_mesh`)

The port of `repro.launch.mesh`.  The production shapes are tables
that hold no devices: the dry-run (`launch.cells`) reads them to divide
each tensor's bytes by the axes its spec names and a step's counts by
the device count.  The population mesh and the host mesh hold real
devices (`DeviceMesh`), named as the co-search entry points name them
(`device.resolve_devices`): a single device is one device (``"cuda"``
the current card), and a sequence may repeat a device, so one card or
the CPU can hold several shards.  The training mesh is a
`torch.distributed` DeviceMesh over processes: NCCL between cards,
gloo between CPU processes.  The fake mesh is a `torch.distributed`
DeviceMesh of this process alone: its process group is the fake one,
whose collectives send nothing, so DTensor plans a production mesh's
step without its cards (the dry-run's collective census).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import DEFAULT_DEVICE, rank_device, resolve_devices

TRAIN_AXES = ("pod", "data", "model")


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


def parse_mesh(text: str) -> tuple[int, int, int]:
    """"1x2x2" -> (1, 2, 2): the POD x DATA x MODEL sizes."""
    parts = text.lower().split("x")
    if len(parts) != len(TRAIN_AXES) or not all(p.isdigit() for p in parts):
        raise ValueError(f"mesh {text!r} is not POD x DATA x MODEL, "
                         "e.g. 1x2x2")
    shape = tuple(int(p) for p in parts)
    if min(shape) < 1:
        raise ValueError(f"mesh {text!r} has an empty axis")
    return shape


def init_train_mesh(shape, *, device: str = DEFAULT_DEVICE,
                    init_method: str = "env://",
                    world_size: int | None = None, rank: int | None = None):
    """The training mesh of this process: a `torch.distributed`
    DeviceMesh of `shape` (pod, data, model) over axes ("pod", "data",
    "model"), one process a device.  An axis of size 1 shards nothing
    and is left out of the DeviceMesh (a mesh of one device keeps
    "data"): the specs are sanitized against the axes present, as the
    reference's single-pod mesh has no "pod", and DTensor plans each
    new operation over every mesh dim, which cost a reduced Qwen3's
    first step 21 s on a CPU rank of a (2, 2, 2) mesh and 1.4-1.8 s
    over one dim of size 2 or 4 (then 0.2 s a step either way).  It
    joins the process group from `init_method`
    (``tcp://localhost:<port>``, or torchrun's ``env://``),
    `world_size` and `rank` (torchrun's ``WORLD_SIZE`` and ``RANK``
    when None) unless one is already up.  On ``"cuda"`` the
    backend is NCCL and the process's card is ``cuda:<local rank>``
    (`device.rank_device`), on ``"cpu"`` gloo.  A CUDA request without
    a card or without NCCL raises: nothing falls back to gloo or to the
    CPU.  `close_train_mesh` leaves the group."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(TRAIN_AXES):
        raise ValueError(f"a training mesh has {len(TRAIN_AXES)} axes "
                         f"{TRAIN_AXES}, got {shape}")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda training mesh needs a card; "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda training mesh needs NCCL, which "
                               "this torch build lacks")
        backend = "nccl"
    elif dev_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a training mesh runs on 'cuda' or 'cpu', not "
                         f"{dev_type!r}")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                         f"processes, the world has {world_size}")
    local = os.environ.get("LOCAL_RANK")
    dev = rank_device(dev_type, rank, None if local is None else int(local))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, device_id=dev if dev.type == "cuda" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"a {dev_type} mesh needs {backend}")
    sizes, names = _kept_axes(shape, TRAIN_AXES)
    return init_device_mesh(dev_type, sizes, mesh_dim_names=names)


def _kept_axes(sizes, names) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The sizes and names of the axes a DeviceMesh keeps: those of size
    above 1, or "data" alone for a mesh of one device."""
    kept = [(n, a) for n, a in zip(sizes, names) if n > 1] or [(1, "data")]
    return tuple(n for n, _ in kept), tuple(a for _, a in kept)


@contextlib.contextmanager
def fake_production_mesh(mesh: dict[str, int],
                         device: str = DEFAULT_DEVICE):
    """A DeviceMesh of `mesh`'s shape (`make_production_mesh`'s, or any
    {axis: size}; size-1 axes left out as `init_train_mesh` leaves them)
    over a fake process group of its device count, this process rank 0.
    The group is the process's default group for the body and is
    destroyed on leaving, whether the body returned or raised.

    `device` is the mesh's device type, which picks DTensor's plans:
    ``"cuda"`` NCCL's (an all-to-all moves a shard between tensor dims),
    ``"cpu"`` gloo's (the all-to-all done as an all-gather and a
    chunk).  No card is used, but ``"cuda"`` needs a torch built with
    CUDA; nothing falls back from one to the other.  A process that is
    already in a process group (a real training mesh) raises a
    ValueError: the fake group would replace its default group."""
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if torch.version.cuda is None:
            raise RuntimeError(
                "a fake cuda mesh plans NCCL's collectives and needs a "
                "torch built with CUDA (no card); this build has none: "
                "device='cpu' counts gloo's plans")
    elif dev_type != "cpu":
        raise ValueError(f"a fake mesh is of 'cuda' or 'cpu', not "
                         f"{dev_type!r}")
    if dist.is_initialized():
        raise ValueError("a process group is already up in this process; "
                         "a fake production mesh would replace it, so "
                         "count from a process outside any training mesh")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sizes, names = _kept_axes(mesh.values(), mesh.keys())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_devices(mesh))
    try:
        yield init_device_mesh(dev_type, sizes, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def close_train_mesh() -> None:
    """Leave the process group `init_train_mesh` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()

