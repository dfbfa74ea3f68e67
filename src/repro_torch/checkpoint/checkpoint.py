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
`torch.bfloat16` tensors (numpy has no bfloat16).  Writes go to a temp
dir + atomic rename: a crash mid-write never corrupts LATEST.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch


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
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    stored = {k: _host_array(v) for k, v in flat.items()}
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
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ptr = Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (Path(ckpt_dir) / name / "meta.json").exists():
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str | Path, step: int | None = None
            ) -> tuple[int, dict]:
    """Load (step, state): numpy leaves, bfloat16 leaves as
    `torch.bfloat16` tensors on the CPU."""
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
    return meta["step"], _unflatten(flat)
