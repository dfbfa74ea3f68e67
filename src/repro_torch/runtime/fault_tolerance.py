"""Fault-tolerant training driver: the port of
`repro.runtime.fault_tolerance`, with the reference's rollback, resume
and straggler logic.

* **checkpoint/restart** — atomic checkpoints every `ckpt_every` steps
  (`checkpoint.checkpoint`, the reference's on-disk format); on
  (re)start the driver resumes from LATEST.  The data pipeline is
  stateless-by-step, so resume repeats the same batches.
* **failure containment** — a step that raises a transient fault
  (`runtime.faults.TRANSIENT_TYPES`: a RuntimeError such as a CUDA
  out-of-memory error or an injected node failure, an OSError, a
  FloatingPointError) rolls back to the last checkpoint and retries;
  `max_restarts` bounds the retry budget.  Other faults propagate.
* **straggler mitigation** — per-step time is tracked against a rolling
  median; steps slower than `straggler_factor` x median are logged.

The train step updates the parameter and optimizer tensors in place
(`train.optimizer`), so a rollback copies the checkpoint's values back
into those same tensors.  The step clock is `obs.telemetry.
default_clock`, as in the reference.

Over a training mesh (the parameters are DTensors) every rank runs the
driver: each builds its own rows of the step's batch
(`data.pipeline.make_batch_rows`), the checkpoint is written whole by
rank 0 (`checkpoint.save`) and read back by every rank into its
shards, and only rank 0 logs.  Two rules keep the ranks in step:
  * a failed collective (`faults.FATAL_TYPES`) is never retried: the
    other ranks wait in it;
  * a rollback is taken by every rank at the same step.  The fault
    hook's outcome is agreed over the whole mesh before the step runs
    (an all-reduce of one flag), so a transient fault on any rank rolls
    every rank back; a non-finite loss is the same on every rank.  A
    transient fault raised inside the step or a checkpoint write,
    between their collectives, cannot be agreed without another
    collective the others may never reach, so under a mesh it leaves
    as `RankFault`, which no rollback catches.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..checkpoint import checkpoint as ckpt
from ..data.pipeline import DataConfig, make_batch, make_batch_rows
from ..device import canonical_device
from ..obs import telemetry as _obs
from ..train.optimizer import tree_leaves, tree_map
from ..train.train_step import rank_rows
from . import faults


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    max_restarts: int = 3
    straggler_factor: float = 2.0
    log_every: int = 10


@dataclasses.dataclass
class DriverReport:
    steps_run: int
    restarts: int
    straggler_steps: list
    losses: list
    resumed_from: int | None


@torch.no_grad()
def _copy_restored(t: torch.Tensor, r) -> None:
    r = torch.as_tensor(r)
    if isinstance(t, DTensor):
        local = t.to_local()
        local.copy_(distribute_tensor(r.to(local.device), t.device_mesh,
                                      t.placements,
                                      src_data_rank=None).to_local())
    else:
        t.copy_(r)


def _restore_into(live, restored) -> None:
    """Copy a restored tree (numpy or CPU tensor leaves, whole) into the
    live tensors of the same tree, in place: a DTensor takes this
    rank's shard."""
    tree_map(_copy_restored, live, restored)


class _PeerFault(RuntimeError):
    """Another rank's fault hook failed at this step: this rank rolls
    back with it."""


def _agreed_hook(fault_hook, step: int, mesh) -> None:
    """Run `fault_hook(step)`; over a mesh, agree on its outcome: if any
    rank's hook raised a transient fault, every rank raises one (its
    own, or `_PeerFault`), so all roll back at this step."""
    err = None
    try:
        fault_hook(step)
    except faults.TRANSIENT_TYPES as e:
        if mesh is None or isinstance(e, faults.FATAL_TYPES):
            raise
        err = e
    if mesh is None:
        return
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32,
                        device=canonical_device(mesh.device_type))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    if err is not None:
        raise err
    if flag.item():
        raise _PeerFault(f"another rank's fault at step {step}")


class RankFault(Exception):
    """A transient fault one rank of a mesh raised inside a step or a
    checkpoint write, between collectives: fatal, since a rollback the
    other ranks do not take leaves them blocked."""


@contextlib.contextmanager
def _one_rank_faults_fatal(mesh):
    """Over a mesh, a transient fault raised in the block leaves the
    driver as `RankFault` instead of rolling back; nothing changes
    without one."""
    if mesh is None:
        yield
        return
    try:
        yield
    except faults.FATAL_TYPES:
        raise
    except faults.TRANSIENT_TYPES as e:
        raise RankFault(f"rank {dist.get_rank()}: {e}") from e


def train_with_recovery(train_step: Callable, params, opt_state,
                        data_cfg: DataConfig, cfg: DriverConfig,
                        fault_hook: Callable[[int], None] | None = None,
                        log: Callable[[str], None] = print
                        ) -> tuple[dict, dict, DriverReport]:
    """Run `total_steps`, checkpointing and restarting on failure.
    Batches go to the parameters' device.  `fault_hook(step)` may raise
    to simulate a node failure.  Over a training mesh (DTensor
    parameters) every rank calls it alike (module doc)."""
    ckpt_dir = Path(cfg.ckpt_dir)
    first = tree_leaves(params)[0]
    mesh = first.device_mesh if isinstance(first, DTensor) else None
    device = first.device
    if mesh is not None and dist.get_rank() != 0:
        log = _quiet
    restarts = 0
    stragglers: list[int] = []
    losses: list[float] = []
    durations: list[float] = []

    def batch_at(step: int) -> dict:
        if mesh is None:
            arrays = make_batch(data_cfg, step)
        else:
            arrays = make_batch_rows(data_cfg, step, *rank_rows(
                mesh, data_cfg.global_batch))
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    start = ckpt.latest_step(ckpt_dir)
    resumed_from = start
    if start is not None:
        _, state = ckpt.restore(ckpt_dir)
        _restore_into(params, state["params"])
        _restore_into(opt_state, state["opt"])
        log(f"[driver] resumed from step {start}")
    step = start or 0

    while step < cfg.total_steps:
        try:
            if fault_hook is not None:
                _agreed_hook(fault_hook, step, mesh)
            batch = batch_at(step)
            with _one_rank_faults_fatal(mesh):
                t0 = _obs.default_clock()
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])
                dt = _obs.default_clock() - t0
            # The loss is the same on every rank: all raise here alike.
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at {step}")
            durations.append(dt)
            losses.append(loss)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > cfg.straggler_factor * med:
                stragglers.append(step)
                log(f"[driver] straggler step {step}: {dt:.3f}s "
                    f"(median {med:.3f}s)")
            step += 1
            if step % cfg.log_every == 0:
                log(f"[driver] step {step} loss {loss:.4f} "
                    f"({dt*1e3:.0f} ms)")
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                with _one_rank_faults_fatal(mesh):
                    ckpt.save(ckpt_dir, step,
                              {"params": params, "opt": opt_state})
        # Shared fault taxonomy (runtime.faults): only transient-class
        # faults are worth a rollback-retry; poison/fatal propagate.
        except faults.FATAL_TYPES:
            raise
        except faults.TRANSIENT_TYPES as e:
            restarts += 1
            log(f"[driver] step {step} failed ({e}); restart "
                f"{restarts}/{cfg.max_restarts}")
            if restarts > cfg.max_restarts:
                raise
            prev = ckpt.latest_step(ckpt_dir)
            if prev is None:
                step = 0
            else:
                _, state = ckpt.restore(ckpt_dir)
                _restore_into(params, state["params"])
                _restore_into(opt_state, state["opt"])
                step = prev
    return params, opt_state, DriverReport(
        steps_run=step, restarts=restarts, straggler_steps=stragglers,
        losses=losses, resumed_from=resumed_from)


def _quiet(_msg: str) -> None:
    """The log of a rank other than 0 of a mesh."""
