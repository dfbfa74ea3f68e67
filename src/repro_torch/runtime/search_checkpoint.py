"""Preemption-safe checkpointing for in-flight co-search tasks.

The PyTorch port of `repro.runtime.search_checkpoint`, writing the same
files through the port's `checkpoint`, so a task checkpointed by the
reference's service resumes in the port's and the other way round.

The serving layer (`serve.cosearch_service`) advances a batched search
one rounding segment at a time; between segments the whole task state
is tiny and host-resident — the rounded log-factor population, the
ordering choices, and each request's oracle-accounting snapshot.  This
module serializes exactly that state through `checkpoint.checkpoint`'s
atomic save/restore, so a killed server resumes a task *bit-identically*
to an uninterrupted run (pinned by tests/test_torch_serve.py): the rounded
population is the complete search state (theta restarts from the
rounded integer logs each segment), and the recorder snapshot restores
`n_evals`, `history`, `start_edps` and the running best exactly.

Failure handling follows the shared `runtime.faults` taxonomy: a
segment that raises a transient fault rolls the task back to its last
checkpoint and retries with backoff.  Restore is crash-consistent: a
torn/partial checkpoint (truncated arrays.npz, mangled meta.json) is
skipped and the previous good step is restored instead — deterministic
replay from an older checkpoint reaches the same final state.

Disk hygiene (`CheckpointGC`): completed tasks delete their checkpoint
directory on drain, and total checkpoint disk is bounded by an LRU
sweep over task directories (recency tracked through `core.lru`,
primed from directory mtimes on restart).
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import zipfile
from pathlib import Path

import numpy as np

from ..checkpoint import checkpoint as ckpt
from ..core.hw_infer import minimal_hw_for
from ..core.lru import LRUCache
from ..core.mapping import stack_mappings, unstack_mappings
from ..obs import telemetry as _obs


def _ckpt_metrics(op: str, n_bytes: int, seconds: float) -> None:
    """Byte + latency accounting for one checkpoint operation, into
    the global registry (rendered at ``/v1/metrics``)."""
    m = _obs.get_metrics()
    m.counter("checkpoint_ops_total", "checkpoint operations",
              ("op",)).inc(op=op)
    m.counter("checkpoint_bytes_total", "bytes written/read/freed "
              "by checkpoint operations", ("op",)).inc(max(n_bytes, 0),
                                                       op=op)
    m.histogram("checkpoint_seconds", "checkpoint operation latency",
                ("op",)).observe(seconds, op=op)

# What a torn/partial/corrupt checkpoint read raises: truncated npz
# (BadZipFile/OSError/EOFError), mangled meta.json (JSONDecodeError is
# a ValueError), missing keys after a partial write (KeyError).
CORRUPT_CHECKPOINT_FAULTS = (OSError, EOFError, KeyError, ValueError,
                             zipfile.BadZipFile, json.JSONDecodeError)


def recorder_state(rec) -> dict:
    """Snapshot a `search._Recorder` as a flat dict of numpy arrays
    (the only thing `checkpoint.checkpoint` stores)."""
    best = rec.best
    state = {
        "evals": np.int64(rec.evals),
        "start_edps": np.asarray(best.start_edps, dtype=np.float64),
        "hist_evals": np.asarray([h[0] for h in best.history],
                                 dtype=np.int64),
        "hist_edps": np.asarray([h[1] for h in best.history],
                                dtype=np.float64),
        "best_edp": np.float64(best.best_edp),
        "has_best": np.int64(1 if best.best_mappings else 0),
    }
    if best.best_mappings:
        fs, orders = stack_mappings(best.best_mappings)
        state["best_fs"] = fs
        state["best_orders"] = orders
    return state


def load_recorder(rec, state: dict) -> None:
    """Restore a fresh `_Recorder` to a `recorder_state` snapshot.

    The running best's hardware point is recomputed from the restored
    best mappings exactly as `_Recorder.record` derives it, so the
    resumed result equals the uninterrupted one field-for-field."""
    rec.evals = int(state["evals"])
    best = rec.best
    best.start_edps = [float(x)
                       for x in np.atleast_1d(state["start_edps"])]
    best.history = [(int(e), float(d)) for e, d in
                    zip(np.atleast_1d(state["hist_evals"]),
                        np.atleast_1d(state["hist_edps"]))]
    best.best_edp = float(state["best_edp"])
    if int(state["has_best"]):
        mappings = unstack_mappings(np.asarray(state["best_fs"],
                                               dtype=float),
                                    np.asarray(state["best_orders"]))
        best.best_mappings = mappings
        cfg = rec.cfg
        hw = minimal_hw_for(rec.cspec, mappings,
                            list(rec.workload.layers))
        if cfg.fixed_hw is not None and cfg.fix_pe_only:
            hw = dataclasses.replace(hw, pe_dim=cfg.fixed_hw.pe_dim)
        elif cfg.fixed_hw is not None:
            hw = cfg.fixed_hw
        best.best_hw = hw


def task_dir(root: str | Path, task_id: str) -> Path:
    return Path(root) / f"task_{task_id}"


def save_task(root: str | Path, task_id: str, seg_idx: int,
              theta: np.ndarray, orders: np.ndarray,
              rec_states: list[dict]) -> None:
    """Checkpoint one batched search task after completing segment
    `seg_idx - 1` (i.e. `seg_idx` segments are done)."""
    state = {"theta": np.asarray(theta),
             "orders": np.asarray(orders),
             "recs": {str(i): rs for i, rs in enumerate(rec_states)}}
    d = task_dir(root, task_id)
    t0 = _obs.default_clock()
    with _obs.get_tracer().span("checkpoint.save", task_id=task_id,
                                seg_idx=seg_idx) as sp:
        ckpt.save(d, seg_idx, state,
                  extra_meta={"task_id": task_id,
                              "n_requests": len(rec_states)})
        # The reference names the step directory without its zero
        # padding here, so it reports 0 bytes; kept for equal metrics
        # (ROADMAP queue 3).
        n_bytes = dir_bytes(d / f"step_{seg_idx}")
        sp.set(bytes=n_bytes)
    _ckpt_metrics("save", n_bytes, _obs.default_clock() - t0)


def _step_ids(d: Path) -> list[int]:
    """Step indices present on disk, newest first — read from the
    directory listing, NOT the LATEST pointer, so a good older step is
    reachable even when the newest write was torn."""
    if not d.is_dir():
        return []
    steps = []
    for child in d.iterdir():
        name = child.name
        if child.is_dir() and name.startswith("step_") \
                and name.split("_")[1].isdigit():
            steps.append(int(name.split("_")[1]))
    return sorted(steps, reverse=True)


def restore_task(root: str | Path, task_id: str
                 ) -> tuple[int, np.ndarray, np.ndarray, list[dict]] | None:
    """Load the newest *readable* checkpoint of a task, or None if it
    has no intact one.  Returns (segments_done, theta, orders, recorder
    snapshots).

    Crash consistency: a corrupt or partial newest step (torn write,
    bitrot) is skipped and the previous good step restores instead —
    the serving layer's replay is deterministic, so resuming from an
    older segment reaches a bit-identical final state."""
    d = task_dir(root, task_id)
    t0 = _obs.default_clock()
    with _obs.get_tracer().span("checkpoint.restore",
                                task_id=task_id) as sp:
        for step in _step_ids(d):
            try:
                seg_idx, state = ckpt.restore(d, step)
                rec_states = list(state["recs"])
                n_bytes = dir_bytes(d / f"step_{step}")   # as in save_task
                sp.set(bytes=n_bytes, step=step)
                _ckpt_metrics("restore", n_bytes,
                              _obs.default_clock() - t0)
                return seg_idx, np.asarray(state["theta"]), \
                    np.asarray(state["orders"]), rec_states
            except CORRUPT_CHECKPOINT_FAULTS:
                sp.event("torn_checkpoint", step=step)
                _obs.get_metrics().counter(
                    "checkpoint_torn_total",
                    "corrupt/torn checkpoint steps skipped on restore"
                ).inc()
                continue   # torn/partial: fall back to previous step
    return None


# ---------------------------------------------------------------------------
# Garbage collection
# ---------------------------------------------------------------------------

def dir_bytes(path: Path) -> int:
    """Total bytes under `path` (0 if it does not exist)."""
    path = Path(path)
    if not path.is_dir():
        return 0
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def delete_task(root: str | Path, task_id: str) -> int:
    """Remove one task's checkpoint directory; returns bytes freed."""
    d = task_dir(root, task_id)
    freed = dir_bytes(d)
    if d.is_dir():
        shutil.rmtree(d)
    return freed


class CheckpointGC:
    """Bounds total checkpoint disk under `root`.

    Recency is tracked through a `core.lru.LRUCache` (task_id -> True):
    every save/restore `touch()`es its task, completed tasks `remove()`
    on drain, and `sweep()` deletes least-recently-used task dirs until
    the total is back under `max_bytes` (None = unbounded; completed-
    task deletion still applies).  On construction the LRU is primed
    from directory mtimes, so a restarted server sweeps sanely."""

    def __init__(self, root: str | Path, max_bytes: int | None = None,
                 max_tasks: int = 4096):
        self.root = Path(root)
        self.max_bytes = max_bytes
        self._lru = LRUCache(maxsize=max_tasks)
        self.removed_tasks = 0
        self.bytes_freed = 0
        if self.root.is_dir():
            dirs = [d for d in self.root.iterdir()
                    if d.is_dir() and d.name.startswith("task_")]
            for d in sorted(dirs, key=lambda p: p.stat().st_mtime):
                self._lru.put(d.name[len("task_"):], True)

    def touch(self, task_id: str) -> None:
        self._lru.put(task_id, True)

    def remove(self, task_id: str) -> int:
        """Drop a completed task's checkpoints (drain-time GC)."""
        t0 = _obs.default_clock()
        freed = delete_task(self.root, task_id)
        self._lru.discard(task_id)
        if freed:
            self.removed_tasks += 1
            self.bytes_freed += freed
            _ckpt_metrics("gc", freed, _obs.default_clock() - t0)
        return freed

    def total_bytes(self) -> int:
        return dir_bytes(self.root)

    def sweep(self) -> list[str]:
        """LRU-sweep task dirs until total disk <= max_bytes.  Returns
        the task_ids removed."""
        if self.max_bytes is None:
            return []
        swept = []
        t0 = _obs.default_clock()
        while len(self._lru) > 1 and self.total_bytes() > self.max_bytes:
            item = self._lru.pop_lru()
            if item is None:
                break
            task_id = item[0]
            freed = delete_task(self.root, task_id)
            if freed:
                self.removed_tasks += 1
                self.bytes_freed += freed
                _ckpt_metrics("gc", freed, _obs.default_clock() - t0)
                t0 = _obs.default_clock()
            swept.append(task_id)
        return swept

    def stats(self) -> dict:
        return {"removed_tasks": self.removed_tasks,
                "bytes_freed": self.bytes_freed,
                "live_tasks": len(self._lru),
                "live_bytes": self.total_bytes(),
                "max_bytes": self.max_bytes}
