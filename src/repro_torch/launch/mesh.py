"""Production mesh shapes, as axis name -> size tables.

Single pod:  (16, 16)      axes ("data", "model")        = 256 devices
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices

The port of `repro.launch.mesh.make_production_mesh`'s shapes only: a
table holds no devices.  The dry-run (`launch.cells`) reads it to
divide each tensor's bytes by the axes its spec names and a step's
counts by the device count.  The population mesh and the host mesh are
multi-GPU work (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_name(mesh: dict[str, int]) -> str:
    """"16x16", "2x16x16": the sizes in axis order."""
    return "x".join(str(n) for n in mesh.values())


def mesh_devices(mesh: dict[str, int]) -> int:
    return math.prod(mesh.values())
