"""Unified fault taxonomy + retry policy for the serving runtime.

The PyTorch port of `repro.runtime.faults`, the same classification:

* **transient** — device/runtime faults (preemption, OOM — torch
  surfaces them as `RuntimeError` subclasses, `torch.OutOfMemoryError`
  included), checkpoint I/O failures
  (`OSError`) and bad numeric state (`FloatingPointError`).  Worth
  retrying with exponential backoff, bounded by `RetryPolicy.max_retries`.
* **poison** — a deterministic input failure: the same fault signature
  (type + message) re-fires after a replay.  `ValueError` starts with
  one retry of grace (it *can* be a transient decode hiccup); a second
  identical failure proves determinism and reclassifies to poison.
  Poison work is quarantined, never retried — one bad request must not
  exhaust a batch's restart budget or take sibling requests down.
* **fatal** — programming errors (`AttributeError`, `TypeError`, ...)
  and anything unrecognized: propagate immediately, loudly.

Deadlines (`Deadline`) and backoff (`backoff_s`) take an *injected*
clock so engine-path code never reads the wall clock directly (rule
ND202); the serving layer defaults the clock at its boundary.
"""
from __future__ import annotations

import dataclasses

# Fault classes ------------------------------------------------------------

TRANSIENT = "transient"
POISON = "poison"
FATAL = "fatal"

# The fault types a retry can in principle recover from.  A sticky CUDA
# error is a RuntimeError too and no retry clears it; the reference's
# taxonomy is kept as it is (ROADMAP open question).  `NotImplementedError`
# is a RuntimeError as well, so the port raises its "not ported yet"
# errors when a request is submitted, never inside a segment.
TRANSIENT_TYPES = (RuntimeError, OSError, FloatingPointError)

# Deterministic-input suspects: retried once, then poison on an
# identical re-failure (see module doc).
POISON_SUSPECT_TYPES = (ValueError,)


class ShardLossFault(RuntimeError):
    """A multi-device population shard became unreachable mid-segment.

    Transient like any RuntimeError, but carries a degradation hint:
    the serving layer re-resolves the engine to ``shards=1`` before
    retrying and flags the outcome ``degraded`` instead of failing."""


class SurrogateFault(RuntimeError):
    """The learned latency model failed inside the engine.  The serving
    layer falls back to the analytical model (outcome ``degraded``)."""


def fault_signature(exc: BaseException) -> str:
    """Identity of a failure for determinism detection: the same type
    raising the same message after a bit-identical replay is, by the
    repo's own seeded-replay guarantee, a deterministic failure."""
    return f"{type(exc).__name__}:{exc}"


def classify(exc: BaseException, seen_before: bool = False) -> str:
    """Map one raised fault to its class.  `seen_before` says whether
    this exact `fault_signature` already failed a replay of the same
    work — which proves the failure deterministic."""
    if isinstance(exc, POISON_SUSPECT_TYPES) and not isinstance(
            exc, TRANSIENT_TYPES):
        return POISON if seen_before else TRANSIENT
    if isinstance(exc, TRANSIENT_TYPES):
        return TRANSIENT
    return FATAL


def fault_record(exc: BaseException, fault_class: str,
                 retries: int = 0) -> dict:
    """The structured error a quarantined/failed outcome carries."""
    return {"fault_class": fault_class,
            "type": type(exc).__name__,
            "message": str(exc),
            "retries": retries}


# Retry policy -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-task retry budget + exponential backoff schedule."""
    max_retries: int = 2            # transient retries per task
    backoff_base_s: float = 0.05    # first-retry delay
    backoff_factor: float = 2.0     # delay multiplier per retry
    backoff_max_s: float = 2.0      # delay ceiling

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry `attempt` (1-based), exponentially grown
        and capped.  Deterministic — no jitter, so seeded chaos runs
        replay exactly."""
        if attempt < 1:
            return 0.0
        return min(self.backoff_base_s
                   * self.backoff_factor ** (attempt - 1),
                   self.backoff_max_s)


# Verdicts a RetryState hands back to the driver.
RETRY = "retry"
QUARANTINE = "quarantine"
GIVE_UP = "give_up"


class RetryState:
    """Per-task fault bookkeeping: counts transient retries against the
    policy budget, detects deterministic re-failure (same signature
    twice => poison), and accumulates the backoff the driver owes."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.retries = 0
        self.backoff_total_s = 0.0
        self._signatures: set[str] = set()
        self.last_fault: dict | None = None

    def next_action(self, exc: BaseException) -> tuple[str, float]:
        """Classify `exc` and decide: ``(RETRY, delay_s)`` to roll back
        and replay after `delay_s`, ``(QUARANTINE, 0)`` for poison work,
        or ``(GIVE_UP, 0)`` for fatal faults / exhausted budgets (the
        driver re-raises)."""
        sig = fault_signature(exc)
        cls = classify(exc, seen_before=sig in self._signatures)
        self._signatures.add(sig)
        self.last_fault = fault_record(exc, cls, self.retries)
        if cls == FATAL:
            return GIVE_UP, 0.0
        if cls == POISON:
            return QUARANTINE, 0.0
        if self.retries >= self.policy.max_retries:
            return GIVE_UP, 0.0
        self.retries += 1
        delay = self.policy.backoff_s(self.retries)
        self.backoff_total_s += delay
        return RETRY, delay


# Deadlines ----------------------------------------------------------------

class Deadline:
    """A wall-clock budget measured through an injected clock (the
    serving layer passes its `ServiceConfig.clock_fn`; tests pass a
    fake).  `None` seconds means no deadline."""

    def __init__(self, clock, seconds: float | None):
        self._clock = clock
        self.seconds = seconds
        self._t0 = clock()

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def expired(self) -> bool:
        return self.seconds is not None and self.elapsed() >= self.seconds

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return max(0.0, self.seconds - self.elapsed())
