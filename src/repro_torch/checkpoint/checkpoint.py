"""Atomic checkpointing of dicts and lists of arrays.

The PyTorch port of `repro.checkpoint.checkpoint`, in the same on-disk
format, so a checkpoint written by either package restores in the
other:

    <dir>/step_<N>/
        meta.json       (step, flat key list, dtypes, extra meta)
        arrays.npz      (flat arrays; bfloat16 stored as a uint16 view)
    <dir>/LATEST        (atomic pointer file)

Leaves are numpy arrays or torch tensors (any device; they are copied
to the host).  `restore` returns numpy arrays, and bfloat16 leaves as
`torch.bfloat16` tensors (numpy has no bfloat16), or each leaf placed
as `restore`'s `shardings` says.  Writes go to a temp
dir + atomic rename: a crash mid-write never corrupts LATEST.

A state of DTensors (training over a mesh of processes) is written in
the same format, whole: every rank gathers each leaf in turn (the
reference's `device_get`), rank 0 alone copies them to the host and
writes them, and every
rank returns once LATEST names the new step.  So the single-device
`restore`, and `serve --ckpt-dir`, read it; `restore(shardings=)`
shards it again.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..device import canonical_device
from ..sharding.rules import distribute, shard_tensor


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _lists(root)


def _lists(node):
    """Convert {'0':..,'1':..} dicts back to tuples."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return tuple(_lists(node[str(i)]) for i in range(len(keys)))
    return {k: _lists(v) for k, v in node.items()}


def _host_array(v) -> tuple[np.ndarray, str]:
    """(the array as stored, its dtype name): bfloat16 tensors as their
    uint16 bit pattern under the name "bfloat16"."""
    if isinstance(v, torch.Tensor):
        if isinstance(v, DTensor):
            v = v.full_tensor()
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    return a, str(a.dtype)


def save(ckpt_dir: str | Path, step: int, state: dict,
         extra_meta: dict | None = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    flat = _flatten(state)
    final = ckpt_dir / f"step_{step:08d}"
    if any(isinstance(v, DTensor) for v in flat.values()):
        # Every rank gathers each leaf (a collective); rank 0 alone
        # copies it to the host and writes.
        writer = dist.get_rank() == 0
        stored = {}
        for k, v in flat.items():
            if writer:
                stored[k] = _host_array(v)
            elif isinstance(v, DTensor):
                v.full_tensor()
        if writer:
            _write(ckpt_dir, step, stored, extra_meta)
        dist.barrier()
        return final
    _write(ckpt_dir, step, {k: _host_array(v) for k, v in flat.items()},
           extra_meta)
    return final


def _write(ckpt_dir: Path, step: int, stored: dict,
           extra_meta: dict | None) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    meta = {"step": step, "keys": sorted(stored),
            "dtypes": {k: dt for k, (_, dt) in stored.items()},
            **(extra_meta or {})}

    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in
                                        stored.items()})
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic pointer update
    ptr_tmp = ckpt_dir / ".LATEST.tmp"
    ptr_tmp.write_text(final.name)
    os.replace(ptr_tmp, ckpt_dir / "LATEST")


def latest_step(ckpt_dir: str | Path) -> int | None:
    ptr = Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (Path(ckpt_dir) / name / "meta.json").exists():
        return None
    return int(name.split("_")[1])


def _place(leaf, sharding):
    """One restored leaf placed as its `sharding` entry says: a device
    (a tensor there), a (pop mesh, member spec) pair (the leaf split
    into member blocks on the mesh's devices, `MemberShards`), or a
    (training mesh, PartitionSpec) pair (a DTensor: this rank's shard
    on its device)."""
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
    if isinstance(sharding, tuple):
        mesh, pspec = sharding
        if isinstance(mesh, DeviceMesh):
            return distribute(t.to(canonical_device(mesh.device_type)),
                              mesh, pspec)
        return shard_tensor(t, mesh, pspec)
    return t.to(torch.device(sharding))


def _place_tree(state, shardings):
    if isinstance(state, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_place_tree(v, s) for v, s in zip(state, shardings))
    return _place(state, shardings)


def restore(ckpt_dir: str | Path, step: int | None = None,
            shardings=None) -> tuple[int, dict]:
    """Load (step, state): numpy leaves, bfloat16 leaves as
    `torch.bfloat16` tensors on the CPU.  `shardings`: optional pytree
    congruent with the state — each leaf a device (the leaf becomes a
    tensor there), a (`launch.mesh.make_pop_mesh` mesh, member spec)
    pair (the leaf split into member blocks over the mesh's devices):
    the elastic-rescale path, a checkpoint written at one shard count
    placed onto another; or a (`launch.mesh.init_train_mesh` mesh,
    PartitionSpec) pair: a DTensor placed by the spec."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    with open(d / "meta.json") as f:
        meta = json.load(f)
    with np.load(d / "arrays.npz") as z:
        flat = {}
        for k in meta["keys"]:
            a = z[k]
            if meta["dtypes"][k] == "bfloat16":
                a = torch.from_numpy(
                    a.view(np.int16).copy()).view(torch.bfloat16)
            flat[k] = a
    state = _unflatten(flat)
    if shardings is not None:
        state = _place_tree(state, shardings)
    return meta["step"], state
