"""Carry the reference's state into the port.

The reference hands its state over as plain Python and numpy (the
port never imports it): an `ArchSpec` as the dict of its dataclass
fields (`dataclasses.asdict`), a search population as numpy arrays,
a `PopulationBest` as its three arrays, a fleet member's `SpecParams`
as its eleven arrays, an MLP's parameter list or an LM's parameter
tree with numpy leaves.  Serving checkpoints need no conversion: the
port's `runtime.search_checkpoint` reads and writes the reference's
files.  These functions rebuild the
port's objects from that, on a named device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.archspec import (ArchSpec, BandwidthModel, EpaModel, HWConfig,
                            MemLevel)
from .core.model import PopulationBest
from .device import DEFAULT_DEVICE, resolve_device


def _tuple_or_none(x):
    return None if x is None else tuple(x)


def arch_spec_from_dict(d: dict) -> ArchSpec:
    """An `ArchSpec` from the reference spec's dataclass fields."""
    levels = tuple(
        MemLevel(name=lv["name"], tensors=tuple(lv["tensors"]),
                 word_bytes=lv["word_bytes"], epa=EpaModel(**lv["epa"]),
                 bandwidth=BandwidthModel(**lv["bandwidth"]),
                 size_words=lv["size_words"], searched=lv["searched"],
                 rand_log2_kb=_tuple_or_none(lv["rand_log2_kb"]))
        for lv in d["levels"])
    hw = d.get("default_hw")
    return ArchSpec(
        name=d["name"], levels=levels,
        spatial_sites=tuple(tuple(s) for s in d["spatial_sites"]),
        level0_temporal_dims=tuple(d["level0_temporal_dims"]),
        epa_mac=d["epa_mac"], max_pe_dim=d["max_pe_dim"],
        fixed_pe_dim=d["fixed_pe_dim"],
        dram_block_words=d["dram_block_words"],
        sram_round_bytes=d["sram_round_bytes"],
        rand_pe_log2=tuple(d["rand_pe_log2"]),
        cosa_schedule=(None if d["cosa_schedule"] is None else
                       tuple(tuple(s) for s in d["cosa_schedule"])),
        default_hw=(None if hw is None else
                    HWConfig(pe_dim=hw["pe_dim"],
                             cap_kb=tuple(hw["cap_kb"]))))


def population_from_numpy(theta, orders, device=DEFAULT_DEVICE):
    """(theta float32 (P, L, 2, n_levels, 7), orders int64 (P, L,
    n_levels)) tensors on `device` from numpy arrays."""
    dev = resolve_device(device)
    theta = torch.from_numpy(np.array(theta, dtype=np.float32)).to(dev)
    orders = torch.from_numpy(np.array(orders, dtype=np.int64)).to(dev)
    return theta, orders


def population_best_from_numpy(edp, f, orders,
                               device=DEFAULT_DEVICE) -> PopulationBest:
    """A `PopulationBest` on `device` from its three numpy arrays."""
    dev = resolve_device(device)
    return PopulationBest(
        edp=torch.from_numpy(np.array(edp, dtype=np.float32)).to(dev),
        f=torch.from_numpy(np.array(f, dtype=np.float32)).to(dev),
        orders=torch.from_numpy(np.array(orders, dtype=np.int64)).to(dev))


def spec_params_from_numpy(params, device=DEFAULT_DEVICE):
    """The port's `fleet.SpecParams` (float32 tensors on `device`) from
    the reference's, given as its fields in order (numpy leaves, one
    member or a stacked member axis)."""
    from .core.fleet import SpecParams

    dev = resolve_device(device)
    return SpecParams(*(
        torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
        for x in params))


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of `arr`; bfloat16 arrays (numpy's
    ml_dtypes type, which torch does not read) go over bit for bit."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def surrogate_params_from_numpy(params, device=DEFAULT_DEVICE) -> list:
    """The latency MLP's parameter list (`core.surrogate`) on `device`
    from the reference's: ``[{"w": (in, out), "b": (out,)}, ...]`` with
    numpy leaves (its `init_mlp` output or a trained model's
    `params`), as float32 tensors.  Each layer's input width must be
    the previous layer's output width, and the last layer has one
    output."""
    dev = resolve_device(device)
    out, width = [], None
    for i, p in enumerate(params):
        w = np.asarray(p["w"], dtype=np.float32)
        b = np.asarray(p["b"], dtype=np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],) or \
                (width is not None and w.shape[0] != width):
            raise ValueError(f"layer {i}: w {w.shape}, b {b.shape} do "
                             f"not chain from width {width}")
        width = w.shape[1]
        out.append({"w": torch.from_numpy(w.copy()).to(dev),
                    "b": torch.from_numpy(b.copy()).to(dev)})
    if width != 1:
        raise ValueError(f"the last layer has {width} outputs, not 1")
    return out


def lm_params_from_numpy(cfg, params: dict, device=DEFAULT_DEVICE):
    """The port's `LM` of config `cfg` holding the reference's
    parameters: `params` is the tree `repro.models.lm.LM.init` returns
    (`embed/{tok,unembed}`, `final_norm/scale`, `blocks/slot<i>/...`
    stacked over n_periods), with numpy arrays as leaves (or CPU
    tensors, as `checkpoint.restore` gives bfloat16 leaves).  Every
    leaf must match the port's init in name, shape and type."""
    from .models.lm import LM, abstract_params

    dev = resolve_device(device)
    expected = abstract_params(cfg)

    def carry(ref, exp, path):
        if isinstance(exp, dict):
            if not isinstance(ref, dict) or set(ref) != set(exp):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"{path or 'params'}: keys {got}, "
                                 f"expected {sorted(exp)}")
            return {k: carry(ref[k], exp[k], f"{path}/{k}".lstrip("/"))
                    for k in exp}
        t = ref.detach().cpu().clone() if isinstance(ref, torch.Tensor) \
            else _tensor_from_numpy(np.asarray(ref))
        if tuple(t.shape) != tuple(exp.shape) or t.dtype != exp.dtype:
            raise ValueError(f"{path}: {t.dtype} {tuple(t.shape)}, "
                             f"expected {exp.dtype} {tuple(exp.shape)}")
        return t.to(dev)

    return LM(cfg, device=dev, params=carry(params, expected, ""))
