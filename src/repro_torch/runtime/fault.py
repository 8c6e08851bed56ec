"""Fault tolerance: retrying step execution, heartbeat/straggler detection.

Twin of ``repro/runtime/fault.py`` (no jax in either).

On a real multi-host deployment each worker runs a ``Heartbeat`` and the
coordinator restarts lost workers; here the objects are unit-tested with
injected failures, and ``fabric.FabricManager`` keeps one
``StragglerMonitor`` per member (the training loop that drives
``StepGuard`` comes with ROADMAP A.6):

* ``StepGuard``: executes a step with bounded retries; after
  ``max_retries`` it restores the latest checkpoint and replays.
* ``Heartbeat``/``StragglerMonitor``: EWMA of step wall-time; a step slower
  than ``threshold x`` the EWMA flags a straggler (a fabric member so
  flagged can be failed over like a dead one).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.cplane import CompletionTimeout
from repro_torch.faults.retry import TransientIOError


class StepFailure(RuntimeError):
    pass


#: what a guarded step may legitimately survive: numerics blips, an
#: explicit StepFailure, the typed transient-I/O hierarchy, and a
#: completion timeout.  Bare ``RuntimeError`` is deliberately NOT here
#: any more — it masked genuine bugs as retriable (§9); raise
#: ``StepFailure`` (or a ``TransientIOError``) to opt a failure in.
RETRIABLE_STEP_ERRORS = (FloatingPointError, StepFailure,
                         TransientIOError, CompletionTimeout)


@dataclass
class StepGuard:
    max_retries: int = 2
    on_restore: Optional[Callable[[], Any]] = None  # -> fresh state
    failures: int = 0
    restores: int = 0

    def _attempt(self, step_fn: Callable, state, *args):
        """One bounded retry loop; returns ``(done, result, last_exc)``.
        No backoff after the final attempt — the sleep only ever buys
        time for the *next* try."""
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return True, step_fn(state, *args), None
            except RETRIABLE_STEP_ERRORS as e:
                self.failures += 1
                last = e
                if attempt < self.max_retries:
                    time.sleep(0.01 * (2 ** attempt))  # backoff
        return False, None, last

    def run(self, step_fn: Callable, state, *args):
        ok, result, last = self._attempt(step_fn, state, *args)
        if ok:
            return result
        restored = ""
        if self.on_restore is not None:
            # replay the restored step under the SAME guard: a transient
            # failure right after a restore must not crash the run when
            # the original step was allowed to retry through it
            self.restores += 1
            state = self.on_restore()
            ok, result, last = self._attempt(step_fn, state, *args)
            if ok:
                return result
            restored = " plus a guarded post-restore replay"
        raise StepFailure(f"step failed after {self.max_retries + 1} "
                          f"attempts{restored}") from last


@dataclass
class StragglerMonitor:
    threshold: float = 2.5     # x EWMA
    alpha: float = 0.2
    warmup: int = 3
    ewma: float = 0.0
    n: int = 0
    stragglers: List[int] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            self.ewma = seconds if self.ewma == 0 else \
                (1 - self.alpha) * self.ewma + self.alpha * seconds
            return False
        slow = seconds > self.threshold * self.ewma
        if slow:
            self.stragglers.append(step)
        else:
            # only fold non-straggler samples into the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return slow


@dataclass
class Heartbeat:
    """Worker liveness ledger (coordinator side)."""
    timeout_s: float = 30.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, worker: int, t: Optional[float] = None) -> None:
        self.last_seen[worker] = time.monotonic() if t is None else t

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self.last_seen.items()
                      if now - t > self.timeout_s)
