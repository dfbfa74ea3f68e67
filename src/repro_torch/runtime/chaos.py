"""Deterministic chaos injection for the serving runtime.

The PyTorch port of `repro.runtime.chaos`: the same seeded schedule,
so one seed injects the same fault sequence into either package's
service.

A `ChaosMonkey` attaches to a `serve.cosearch_service.CoSearchService`
through its two instrumentation hooks and injects the failure modes the
fault taxonomy (`runtime.faults`) is built to absorb:

* **transient engine faults** — `fault_hook` raises `RuntimeError`
  before a segment with probability ``p_transient`` (the service rolls
  back to its last checkpoint and retries with backoff);
* **torn checkpoint writes** — `checkpoint_hook` truncates the
  ``arrays.npz`` of the step the service *just* wrote with probability
  ``p_torn_checkpoint`` (restore must fall back to the previous good
  step — or a from-scratch deterministic replay);
* **slow stragglers** — `fault_hook` stalls a segment for
  ``straggler_s`` with probability ``p_straggler`` (deadline-carrying
  requests must time out with structured partial results);
* **process kills** — `kill_resume` drops one service mid-stream and
  builds a fresh one over the same checkpoint directory, resubmitting
  the same requests (tasks must resume from disk, bit-identically).

Everything draws from ONE seeded `np.random.default_rng(seed)`: the
same seed against the same request stream injects the same fault
sequence, so chaos runs are replayable evidence, not flakes: healthy
requests must still answer bit-identically to a fault-free run under
this schedule.  Injection
count is bounded by ``max_faults`` so a high-probability schedule can
never starve forward progress (retry budgets are per-task and finite).

The straggler stall uses the injected ``sleep_fn`` (rule ND202: runtime
code never calls the wall clock directly); tests inject a fake that
advances a fake clock.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable

import numpy as np

from . import search_checkpoint as sckpt


@dataclasses.dataclass
class ChaosConfig:
    """One chaos schedule.  All probabilities are per-hook-call."""
    seed: int = 0
    p_transient: float = 0.0        # raise before a segment
    p_torn_checkpoint: float = 0.0  # truncate the just-written step
    p_straggler: float = 0.0        # stall a segment
    straggler_s: float = 0.01       # stall duration
    max_faults: int | None = None   # total injection bound (None: off)
    sleep_fn: Callable[[float], None] = time.sleep


def tear_checkpoint(root: str | Path, task_id: str, step: int) -> bool:
    """Simulate a crash mid-write: truncate ``arrays.npz`` of one saved
    step to half its bytes (a torn, unreadable zip).  Returns whether a
    file was torn."""
    d = sckpt.task_dir(root, task_id) / f"step_{step:08d}" / "arrays.npz"
    if not d.is_file():
        return False
    blob = d.read_bytes()
    if len(blob) < 2:
        return False
    d.write_bytes(blob[: len(blob) // 2])
    return True


class ChaosMonkey:
    """Seeded fault injector for one service instance."""

    def __init__(self, cfg: ChaosConfig | None = None):
        self.cfg = ChaosConfig() if cfg is None else cfg
        self._rng = np.random.default_rng(self.cfg.seed)
        self.injected = {"transient": 0, "torn_checkpoint": 0,
                         "straggler": 0, "kills": 0}

    def _armed(self) -> bool:
        return (self.cfg.max_faults is None
                or sum(self.injected.values()) < self.cfg.max_faults)

    # -- service hooks -----------------------------------------------------

    def fault_hook(self, task_id: str, seg: int,
                   request_ids: tuple) -> None:
        """Pre-segment injection point (`CoSearchService.fault_hook`)."""
        if self._armed() \
                and self._rng.random() < self.cfg.p_straggler:
            self.injected["straggler"] += 1
            self.cfg.sleep_fn(self.cfg.straggler_s)
        if self._armed() \
                and self._rng.random() < self.cfg.p_transient:
            self.injected["transient"] += 1
            raise RuntimeError(
                f"chaos: injected transient fault "
                f"(task {task_id} seg {seg})")

    def checkpoint_hook(self, root, task_id: str, seg: int) -> None:
        """Post-save injection point (`CoSearchService.checkpoint_hook`):
        tears the step the service believes it just durably wrote."""
        if self._armed() \
                and self._rng.random() < self.cfg.p_torn_checkpoint:
            if tear_checkpoint(root, task_id, seg):
                self.injected["torn_checkpoint"] += 1

    def attach(self, svc) -> "ChaosMonkey":
        """Wire both hooks into a `CoSearchService`."""
        svc.fault_hook = self.fault_hook
        svc.checkpoint_hook = self.checkpoint_hook
        return self

    # -- kill/resume -------------------------------------------------------

    def kill_resume(self, svc, make_service: Callable, requests):
        """Kill a service mid-stream and resume on a fresh instance.

        The old instance is simply abandoned (a killed process holds no
        destructor promises); `make_service()` builds a successor over
        the same checkpoint directory, the same `requests` are
        resubmitted (task ids derive from request ids, so each task
        finds its own checkpoints), and the monkey re-attaches."""
        self.injected["kills"] += 1
        new_svc = make_service()
        self.attach(new_svc)
        for req in requests:
            new_svc.submit(req)
        return new_svc

    def stats(self) -> dict:
        return dict(self.injected)
