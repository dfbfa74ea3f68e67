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
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..checkpoint import checkpoint as ckpt
from ..data.pipeline import DataConfig, make_batch
from ..obs import telemetry as _obs
from ..train.optimizer import tree_leaves, tree_map
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
def _restore_into(live, restored) -> None:
    """Copy a restored tree (numpy or CPU tensor leaves) into the live
    tensors of the same tree, in place."""
    tree_map(lambda t, r: t.copy_(torch.as_tensor(r)), live, restored)


def train_with_recovery(train_step: Callable, params, opt_state,
                        data_cfg: DataConfig, cfg: DriverConfig,
                        fault_hook: Callable[[int], None] | None = None,
                        log: Callable[[str], None] = print
                        ) -> tuple[dict, dict, DriverReport]:
    """Run `total_steps`, checkpointing and restarting on failure.
    Batches go to the parameters' device.  `fault_hook(step)` may raise
    to simulate a node failure."""
    ckpt_dir = Path(cfg.ckpt_dir)
    device = tree_leaves(params)[0].device
    restarts = 0
    stragglers: list[int] = []
    losses: list[float] = []
    durations: list[float] = []

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
                fault_hook(step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in make_batch(data_cfg, step).items()}
            t0 = _obs.default_clock()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch)
            loss = float(metrics["loss"])
            dt = _obs.default_clock() - t0
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
                ckpt.save(ckpt_dir, step,
                          {"params": params, "opt": opt_state})
        # Shared fault taxonomy (runtime.faults): only transient-class
        # faults are worth a rollback-retry; poison/fatal propagate.
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
