"""Typed transient-fault hierarchy + deterministic bounded retry (§9).

The SmartNIC characterization literature (Wei et al., Liu et al. —
PAPERS.md) reports transient completion errors, anomalous latency
spikes, and path-dependent stalls as *first-class behaviors* of real
NIC memory paths — not rare corner cases.  Before this module the repo
had exactly one retry site (``StepGuard`` re-running whole training
steps) and it caught bare ``RuntimeError``, so a genuine bug and a
flaky DMA completion were indistinguishable.

This module gives every layer one vocabulary and one policy:

* ``TransientIOError`` — the root of everything that is *worth
  retrying*: the operation failed for a reason expected to clear
  (flaky completion, flapping node, torn transfer).  Programming
  errors (``IndexError``, ``ValueError``...) deliberately stay
  outside the hierarchy so a retry loop can never mask them.
* ``RetryPolicy`` — bounded exponential backoff with *deterministic*
  jitter (seeded per ``(seed, key, attempt)``, so a chaos run replays
  byte-identically) and a hard total-sleep ``budget_s`` cap: for any
  seed, the sum of all backoff sleeps of one logical op never exceeds
  the budget (property-tested).  Idempotent-read-only by default:
  non-idempotent ops are retried only when the call site explicitly
  declares them safe (full-page writes are — a re-store lands the
  same bytes).

Retries surface through the existing obs plane: each one emits a
``faults.retry`` instant when tracing is on and bumps the
``cplane.<source>.retries`` counter when live metrics are on.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch import obs
from repro_torch.cplane import CompletionTimeout


class TransientIOError(IOError):
    """Root of the retriable fault taxonomy: the op failed for a reason
    expected to clear on retry (or on a replica)."""


class TransientCompletionError(TransientIOError):
    """A work request completed with an error status (the WCStatus.ERROR
    shape): the transfer did not land, but the path is still up."""


class NodeUnavailable(TransientIOError):
    """The target node is (temporarily) not serving — a flapping member
    mid down-window, or a member the routing plane has fail-stopped."""


class InjectedTimeout(CompletionTimeout, TransientIOError):
    """An injected completion timeout (``faults.injector``): shaped like
    ``cplane.CompletionTimeout`` so call sites exercise the exact
    handling a real expiry would, but typed transient for the policy."""


#: what a retry loop may legitimately swallow.  ``CompletionTimeout`` is
#: included explicitly: a timed-out wait on an idempotent read is the
#: canonical "try again" case even though it is not an IOError subclass.
RETRIABLE = (TransientIOError, CompletionTimeout)


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, RETRIABLE)


def _mix(seed: int, key: str, attempt: int) -> float:
    """Deterministic jitter draw in [0, 1): a crc32 of the triple, so
    the schedule is a pure function of (seed, key, attempt) — stable
    across processes (unlike salted ``hash``) and across runs."""
    h = zlib.crc32(f"{seed}:{key}:{attempt}".encode()) & 0xFFFFFFFF
    return h / 2**32


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter and a hard
    total-sleep budget.

    ``max_attempts`` counts *tries*, not retries: 4 means one initial
    attempt plus up to three retries.  The backoff before retry k
    (k >= 1) is ``base_s * multiplier**(k-1)`` capped at
    ``max_backoff_s``, jittered multiplicatively into
    ``[1 - jitter, 1]``, then clipped so the cumulative sleep of the
    whole schedule never exceeds ``budget_s``.
    """

    max_attempts: int = 4
    base_s: float = 0.002
    multiplier: float = 2.0
    max_backoff_s: float = 0.05
    budget_s: float = 0.25
    jitter: float = 0.5                 # fraction of each delay jittered
    seed: int = 0
    retry_non_idempotent: bool = False  # idempotent-read-only by default
    # shared counters (thread-safe): how often this policy actually slept
    retries: int = 0
    giveups: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_s < 0 or self.max_backoff_s < 0 or self.budget_s < 0:
            raise ValueError("backoff times must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    # -- schedule --------------------------------------------------------
    def backoff_s(self, attempt: int, key: str = "",
                  spent_s: float = 0.0) -> float:
        """Sleep before retry ``attempt`` (1-based), given ``spent_s``
        seconds already slept for this logical op.  Never pushes the
        cumulative sleep past ``budget_s``."""
        if attempt < 1:
            raise ValueError(attempt)
        raw = min(self.base_s * self.multiplier ** (attempt - 1),
                  self.max_backoff_s)
        jittered = raw * (1.0 - self.jitter * _mix(self.seed, key, attempt))
        return max(0.0, min(jittered, self.budget_s - spent_s))

    def backoff_schedule(self, key: str = "") -> List[float]:
        """The full deterministic sleep schedule for one logical op —
        what the hypothesis property audits: every entry >= 0 and the
        total <= ``budget_s`` for ANY seed/key."""
        out, spent = [], 0.0
        for attempt in range(1, self.max_attempts):
            d = self.backoff_s(attempt, key, spent)
            out.append(d)
            spent += d
        return out

    def should_retry(self, exc: BaseException, attempt: int,
                     idempotent: bool = True) -> bool:
        """Is retry ``attempt`` (1-based) permitted for ``exc``?"""
        if attempt >= self.max_attempts:
            return False
        if not idempotent and not self.retry_non_idempotent:
            return False
        return is_transient(exc)

    # -- execution -------------------------------------------------------
    def _observe_retry(self, op: str, source: Optional[str], attempt: int,
                       exc: BaseException, delay: float) -> None:
        with self._lock:
            self.retries += 1
        if obs.trace.enabled():
            obs.instant("faults.retry", op=op, attempt=attempt,
                        error=type(exc).__name__, backoff_ms=delay * 1e3)
        if obs.metrics.live():
            obs.default_registry().counter(
                f"cplane.{source or op}.retries").inc()

    def call(self, fn: Callable[[], Any], *, op: str = "io",
             key: str = "", idempotent: bool = True,
             source: Optional[str] = None) -> Any:
        """Run ``fn`` under this policy: transient failures back off and
        retry (deterministic schedule keyed by ``key``) until attempts
        or budget run out; anything non-transient propagates at once."""
        spent = 0.0
        attempt = 1
        while True:
            try:
                return fn()
            except BaseException as e:
                if not self.should_retry(e, attempt, idempotent):
                    if is_transient(e):
                        with self._lock:
                            self.giveups += 1
                    raise
                delay = self.backoff_s(attempt, key or op, spent)
                self._observe_retry(op, source, attempt, e, delay)
                if delay > 0:
                    time.sleep(delay)
                spent += delay
                attempt += 1

    def stats(self) -> dict:
        with self._lock:
            return {"retries": self.retries, "giveups": self.giveups,
                    "max_attempts": self.max_attempts,
                    "budget_s": self.budget_s, "seed": self.seed}


def retry_io(policy: Optional[RetryPolicy],
             issue: Callable[[], "PendingIO"], *, op: str = "io",
             key: str = "", idempotent: bool = True,
             source: Optional[str] = None, nbytes: int = 0) -> "PendingIO":
    """Wrap an async page op (``load_many_async``-shaped: returns a
    ``PendingIO``) in the retry policy.

    The first attempt is issued eagerly so its transfer overlaps the
    caller's work exactly as before; the *join* (and any re-issue) runs
    on the waiting consumer's thread via an eager ``PendingIO`` — never
    on a node/completion thread, where a retry's re-issued work could
    deadlock against the very queue it is waiting on.  With
    ``policy=None`` the op passes through untouched (zero overhead, and
    the reactive/overlap behavior of the underlying handle is kept).
    """
    from repro_torch.rmem.backend import PendingIO
    if policy is None:
        return issue()
    try:
        first = issue()
    except RETRIABLE as e:
        # an inline-completing backend (host memcpy) fails *during*
        # issue; park the error in a pre-failed handle so it surfaces
        # at join — inside the policy, counted as attempt 1 — instead
        # of escaping the retry loop entirely
        def _refail(timeout, _e=e):
            raise _e
        first = PendingIO(_refail)

    def finalize(timeout: float):
        state = {"io": first, "attempt": 0}

        def join():
            if state["io"] is None:
                state["io"] = issue()
            io, state["io"] = state["io"], None
            state["attempt"] += 1
            return io.wait(timeout)
        return policy.call(join, op=op, key=key or op,
                           idempotent=idempotent, source=source)
    return PendingIO(finalize, nbytes=nbytes)
