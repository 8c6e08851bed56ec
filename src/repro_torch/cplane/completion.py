"""The ``Completion`` handle: one wait primitive under every async op.

Before this module the repo had four divergent completion primitives —
``Transfer._event`` (channels), ``WorkItem.done/assigned`` (queues),
``PendingIO`` (rmem backends), ``_Doorbell``/``CompletionQueue`` (verbs)
— each re-implementing the same event-plus-state dance, none of them
composable.  The paper's point is that completion handling (polled vs
interrupt, batch fencing, overlap of in-flight work) is where host<->NIC
memory access is won or lost; a serving loop that cannot *wait on
heterogeneous work at once* cannot overlap decode with paging.

``Completion`` is that one primitive:

* states ``PENDING -> DONE | ERROR | CANCELLED`` (settled exactly once);
* ``wait(timeout)`` / ``poll()`` / ``result()`` for consumers, with
  deadline support (a completion constructed with ``deadline=`` raises
  ``CompletionTimeout`` at that wall, whatever the wait's own timeout);
* ``add_callback(fn)`` — fires from the settling thread, or immediately
  if already settled (the MSI-X analogue);
* producer API ``succeed(result)`` / ``fail(exc)`` / ``cancel()``; lazy
  results (``succeed_lazy``) keep expensive assembly on the *waiter's*
  thread, matching how multi-chunk transfers always worked;
* optional ``poller`` — a polled-mode completion drives its source's
  poll function from the waiting thread instead of sleeping on the
  event, the paper's polled/interrupt contrast as an API property;
* telemetry — a completion bound to a ``Reactor`` source records
  submit/complete (latency, bytes) into that source's EWMA counters.

``wait_any`` / ``wait_all`` / ``as_completed`` compose completions from
*any* producer: a channel Transfer, a verbs doorbell, and a tier
``PendingIO`` can all be raced in one call.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

_POLL_INTERVAL = 2e-4           # polled-mode wait granularity (seconds)


class CompletionState(enum.Enum):
    PENDING = "pending"
    DONE = "done"
    ERROR = "error"
    CANCELLED = "cancelled"


class CompletionTimeout(TimeoutError):
    """A wait (or a deadline) expired before the completion settled.

    Subclasses ``TimeoutError`` so call sites that pre-date the
    completion plane keep catching what they always caught.
    """


class CompletionCancelled(RuntimeError):
    """The completion was cancelled before it could settle."""


class Completion:
    """One settled-exactly-once handle for an in-flight operation."""

    def __init__(self, *, source: Optional[str] = None, reactor=None,
                 deadline: Optional[float] = None,
                 poller: Optional[Callable[[], Any]] = None,
                 nbytes: int = 0):
        """``deadline`` is absolute ``time.monotonic()`` seconds; a wait
        never blocks past it.  ``poller`` makes this a polled-mode
        completion: waits drive it instead of sleeping on the event.
        ``source``+``reactor`` opt into telemetry (submit recorded now,
        latency/bytes recorded at settle)."""
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._state = CompletionState.PENDING
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._lazy: Optional[Callable[[], Any]] = None
        self._callbacks: List[Callable[["Completion"], None]] = []
        self.source = source
        self._reactor = reactor
        self.deadline = deadline
        self._poller = poller
        self.nbytes = nbytes
        self.t_submit = time.perf_counter()
        self.t_done = 0.0
        if reactor is not None and source is not None:
            reactor.on_submit(source)

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> CompletionState:
        return self._state

    def poll(self) -> bool:
        """Non-blocking: has this completion settled?  A polled-mode
        completion drives its source once per call."""
        if self._poller is not None and not self._event.is_set():
            self._poller()
        return self._event.is_set()

    # -- producer API ---------------------------------------------------
    def _settle(self, state: CompletionState, result: Any = None,
                error: Optional[BaseException] = None,
                lazy: Optional[Callable[[], Any]] = None) -> bool:
        with self._lock:
            if self._state is not CompletionState.PENDING:
                return False
            self._state = state
            self._result = result
            self._error = error
            self._lazy = lazy
            self.t_done = time.perf_counter()
            callbacks, self._callbacks = self._callbacks, []
        self._event.set()
        if self._reactor is not None and self.source is not None:
            self._reactor.on_complete(self.source,
                                      self.t_done - self.t_submit,
                                      nbytes=self.nbytes, state=state)
        for cb in callbacks:
            cb(self)
        return True

    def succeed(self, result: Any = None) -> bool:
        return self._settle(CompletionState.DONE, result=result)

    def succeed_lazy(self, fn: Callable[[], Any]) -> bool:
        """Settle DONE with the result produced on first ``result()`` —
        keeps expensive assembly/gather on the consumer's thread.

        Producers must only settle lazily when ``fn`` is expected to
        succeed (production failure flips the state to ERROR after
        callbacks/telemetry already saw DONE); a failure known at settle
        time belongs in ``fail()``."""
        return self._settle(CompletionState.DONE, lazy=fn)

    def fail(self, error: BaseException) -> bool:
        return self._settle(CompletionState.ERROR, error=error)

    def cancel(self) -> bool:
        """Cancel if still pending; returns whether this call won the
        race (a settled completion cannot be cancelled)."""
        return self._settle(
            CompletionState.CANCELLED,
            error=CompletionCancelled(f"{self._describe()} cancelled"))

    # -- consumer API ---------------------------------------------------
    def add_callback(self, fn: Callable[["Completion"], None]) -> None:
        """Run ``fn(self)`` when settled — immediately if already is."""
        with self._lock:
            if self._state is CompletionState.PENDING:
                self._callbacks.append(fn)
                return
        fn(self)

    def remove_callback(self, fn: Callable[["Completion"], None]) -> None:
        """Deregister a not-yet-fired callback (identity match; no-op if
        absent or already fired) — what ``wait_any`` uses so repeated
        bounded waits on long-lived completions don't accumulate dead
        waiter closures."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def _wait_budget(self, timeout: Optional[float]) -> Optional[float]:
        """Absolute monotonic wall for this wait (None = unbounded)."""
        wall = None if timeout is None else time.monotonic() + timeout
        if self.deadline is not None:
            wall = self.deadline if wall is None else min(wall,
                                                          self.deadline)
        return wall

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until settled (within ``timeout`` and the deadline),
        then return ``result()``.  Raises ``CompletionTimeout`` on
        expiry, the producer's error on failure, and
        ``CompletionCancelled`` after a cancel."""
        wall = self._wait_budget(timeout)
        if self._poller is None:
            if wall is None:
                self._event.wait()
            else:
                self._event.wait(max(wall - time.monotonic(), 0.0))
        else:
            while not self._event.is_set():
                self._poller()
                left = None if wall is None else wall - time.monotonic()
                if left is not None and left <= 0:
                    break
                step = _POLL_INTERVAL if left is None else \
                    min(left, _POLL_INTERVAL)
                self._event.wait(step)
        if not self._event.is_set():
            if self.deadline is not None and wall == self.deadline:
                raise CompletionTimeout(
                    f"{self._describe()} deadline expired")
            raise CompletionTimeout(
                f"{self._describe()} still pending after {timeout}s")
        return self.result()

    def result(self) -> Any:
        """The settled result; raises if unsettled, failed or cancelled.
        Idempotent — a lazy result is produced once and cached."""
        if self._state is CompletionState.PENDING:
            raise RuntimeError(f"{self._describe()} has not settled")
        if self._lazy is not None:
            # produce under the lock so a concurrent result() observes
            # either the unproduced state (and blocks here) or the final
            # value — never a half-produced one
            with self._lock:
                if self._lazy is not None:
                    fn, self._lazy = self._lazy, None
                    try:
                        self._result = fn()
                    except BaseException as e:
                        self._state = CompletionState.ERROR
                        self._error = e
        if self._state is CompletionState.ERROR:
            raise self._error
        if self._state is CompletionState.CANCELLED:
            raise self._error or CompletionCancelled(self._describe())
        return self._result

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def seconds(self) -> float:
        return max(self.t_done - self.t_submit, 1e-9)

    def _describe(self) -> str:
        src = f" [{self.source}]" if self.source else ""
        return f"{type(self).__name__}{src}"

    # -- pre-settled constructors ---------------------------------------
    @classmethod
    def done(cls, result: Any = None, **kw) -> "Completion":
        c = cls(**kw)
        c.succeed(result)
        return c

    @classmethod
    def failed(cls, error: BaseException, **kw) -> "Completion":
        c = cls(**kw)
        c.fail(error)
        return c


# -- composition ---------------------------------------------------------
def _walls(completions: Iterable[Completion], timeout: Optional[float]):
    cs = list(completions)
    wall = None if timeout is None else time.monotonic() + timeout
    return cs, wall


def wait_any(completions: Iterable[Completion],
             timeout: Optional[float] = None) -> List[Completion]:
    """Block until at least one completion settles; returns every settled
    one (possibly several).  Heterogeneous by construction: channel
    transfers, verbs doorbells and tier PendingIOs race uniformly.
    Polled-mode members are driven from this thread while waiting."""
    cs, wall = _walls(completions, timeout)
    if not cs:
        return []
    kicked = threading.Event()

    def kick(_c: Completion) -> None:
        kicked.set()

    for c in cs:
        c.add_callback(kick)
    has_polled = any(c._poller is not None for c in cs)
    try:
        while True:
            settled = [c for c in cs if c.poll()]
            if settled:
                return settled
            left = None if wall is None else wall - time.monotonic()
            if left is not None and left <= 0:
                raise CompletionTimeout(
                    f"wait_any: 0/{len(cs)} settled after {timeout}s")
            step = left
            if has_polled:
                step = _POLL_INTERVAL if left is None else \
                    min(left, _POLL_INTERVAL)
            kicked.wait(step)
            kicked.clear()
    finally:
        # unfired callbacks must not pile up on completions that outlive
        # this (possibly timed-out) wait — e.g. serve's per-step grace
        # polls over the same pending fetches
        for c in cs:
            c.remove_callback(kick)


def wait_all(completions: Iterable[Completion],
             timeout: Optional[float] = None) -> List[Any]:
    """Block until every completion settles; returns their results in
    input order.  ``timeout`` bounds the whole batch, not each member."""
    cs, wall = _walls(completions, timeout)
    for c in cs:
        left = None if wall is None else wall - time.monotonic()
        if left is not None and left <= 0 and not c.poll():
            raise CompletionTimeout(
                f"wait_all: incomplete after {timeout}s")
        c.wait(left)
    return [c.result() for c in cs]


def as_completed(completions: Iterable[Completion],
                 timeout: Optional[float] = None) -> Iterator[Completion]:
    """Yield completions in settle order (the overlap primitive: consume
    each batch's bytes the moment they land while the rest keep
    flying).  ``timeout`` bounds the whole drain."""
    pending, wall = _walls(completions, timeout)
    while pending:
        left = None if wall is None else wall - time.monotonic()
        for c in wait_any(pending, left):
            pending.remove(c)
            yield c
