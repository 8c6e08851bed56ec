"""The ``Reactor``: completion delivery + per-source latency telemetry.

Every async producer in the repo registers itself as a *source* — the
XDMA channel pools, the QDMA descriptor queues, the verbs queue pairs
and completion queues, the tier backends.  Polled and interrupt sources
register uniformly: an interrupt source settles its completions from its
own worker thread (MSI-X analogue); a polled source hands the reactor a
``poll()`` callable that waiters (or ``poll_once``) drive.

The payoff is the telemetry: the reactor keeps, per source, submit /
complete / error counters, an in-flight gauge, and EWMAs of completion
latency and op size.  That is the calibration loop the DPU-optimization
literature shows cross-path routing needs — ``PathSelector`` reads these
numbers to replace its static occupancy guess with *measured* queue
state (DESIGN.md §6), and benches dump them next to the analytical
projections.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

from repro_torch import obs
from repro_torch.cplane.completion import Completion, CompletionState


@dataclass
class SourceTelemetry:
    """Live counters for one completion source (mutated under the
    reactor lock; ``snapshot()`` for a consistent copy)."""

    name: str
    mode: str = "interrupt"             # "interrupt" | "polled"
    submitted: int = 0
    completed: int = 0
    errors: int = 0
    cancelled: int = 0
    inflight: int = 0
    bytes_moved: int = 0
    ewma_latency_s: float = 0.0
    ewma_nbytes: float = 0.0
    last_latency_s: float = 0.0
    total_latency_s: float = 0.0        # sum of completion latencies
    sync_ops: int = 0                   # samples fed via record()

    @property
    def ewma_gbps(self) -> float:
        if self.completed > 0 and self.sync_ops >= self.completed \
                and self.total_latency_s > 0:
            # every sample came through record() — a one-shot op whose
            # latency covers exactly its bytes — so the honest aggregate
            # is bytes-weighted (total bytes / total busy seconds); the
            # ratio of two EWMAs would overweight small recent ops
            return self.bytes_moved / self.total_latency_s / 1e9
        if self.ewma_latency_s <= 0:
            return 0.0
        return self.ewma_nbytes / self.ewma_latency_s / 1e9

    def snapshot(self) -> "SourceTelemetry":
        return dataclasses.replace(self)


class Reactor:
    """Owns completion delivery bookkeeping for its registered sources."""

    def __init__(self, ewma_alpha: float = 0.25):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{ewma_alpha}")
        self.ewma_alpha = ewma_alpha
        self._lock = threading.Lock()
        self._sources: Dict[str, SourceTelemetry] = {}
        self._pollers: Dict[str, Callable[[], None]] = {}
        self._ids = itertools.count(1)

    # -- registration ----------------------------------------------------
    def register_source(self, name: str, mode: str = "interrupt",
                        poll: Optional[Callable[[], None]] = None) -> str:
        """Register (idempotently) a completion source.  ``poll`` makes
        it a polled source: ``poll_once()`` and polled-mode waiters drive
        it; interrupt sources settle completions from their own
        threads."""
        if mode not in ("interrupt", "polled"):
            raise ValueError(f"unknown source mode {mode!r}")
        with self._lock:
            st = self._sources.get(name)
            if st is None:
                self._sources[name] = SourceTelemetry(name, mode=mode)
            else:
                st.mode = mode
            if poll is not None:
                self._pollers[name] = poll
            elif mode == "interrupt":
                self._pollers.pop(name, None)
        return name

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)
            self._pollers.pop(name, None)

    def unique_source(self, prefix: str) -> str:
        return f"{prefix}#{next(self._ids)}"

    # -- completion construction ----------------------------------------
    def completion(self, source: Optional[str] = None, nbytes: int = 0,
                   deadline: Optional[float] = None) -> Completion:
        """A completion bound to this reactor: submit is recorded now,
        latency at settle; polled sources hand the waiter their poll
        function."""
        poller = None
        if source is not None:
            with self._lock:
                poller = self._pollers.get(source)
        return Completion(source=source, reactor=self, nbytes=nbytes,
                          deadline=deadline, poller=poller)

    # -- delivery hooks (called by Completion / producers) ---------------
    def on_submit(self, source: str) -> None:
        with self._lock:
            st = self._sources.get(source)
            if st is None:      # unregistered (or closed): drop, don't
                return          # resurrect — owners clean up via
            st.submitted += 1   # unregister_source and stay cleaned up
            st.inflight += 1

    def on_complete(self, source: str, latency_s: float, nbytes: int = 0,
                    state: CompletionState = CompletionState.DONE) -> None:
        a = self.ewma_alpha
        with self._lock:
            st = self._sources.get(source)
            if st is None:      # straggler settling after its owner's
                return          # close: ignore rather than re-create
            st.completed += 1
            st.inflight = max(st.inflight - 1, 0)
            if state is CompletionState.ERROR:
                st.errors += 1
            elif state is CompletionState.CANCELLED:
                st.cancelled += 1
            st.bytes_moved += nbytes
            st.last_latency_s = latency_s
            st.total_latency_s += latency_s
            if st.completed == 1:
                st.ewma_latency_s = latency_s
                st.ewma_nbytes = float(nbytes)
            else:
                st.ewma_latency_s = a * latency_s + \
                    (1 - a) * st.ewma_latency_s
                st.ewma_nbytes = a * nbytes + (1 - a) * st.ewma_nbytes
            mode = st.mode
        if obs.active():
            self._observe(source, mode, latency_s, nbytes, state)
        return None

    def _observe(self, source: str, mode: str, latency_s: float,
                 nbytes: int, state: CompletionState) -> None:
        """Obs-plane wiring per settled completion: a retroactive span
        (submit -> settle) on the source's trace track — which is how
        every access path, verbs doorbell, and fabric member shows up in
        one trace for free — plus a latency histogram sample when live
        metrics are on.  Only runs behind ``obs.active()``."""
        obs.complete(source, time.perf_counter() - latency_s, latency_s,
                     track=f"src:{source}",
                     args={"nbytes": nbytes, "mode": mode,
                           "state": state.value})
        if obs.metrics.live():
            reg = obs.default_registry()
            reg.histogram(f"cplane.{source}.latency_s").record(latency_s)
            if nbytes:
                reg.counter(f"cplane.{source}.bytes").inc(nbytes)

    def record(self, source: str, latency_s: float, nbytes: int = 0,
               ok: bool = True) -> None:
        """One-shot sample for synchronous ops (submit+complete at once)
        — how inline backends (host memcpy) feed the same EWMAs.  The
        in-flight gauge is bumped too so ``on_complete``'s decrement
        nets to zero: a source shared with async producers (the verbs
        ``:page`` source) must not see its genuine in-flight count
        eroded by concurrent sync samples."""
        with self._lock:
            st = self._sources.get(source)
            if st is None:      # same drop policy as on_submit: a late
                return          # sample must not resurrect a source its
            st.submitted += 1   # owner already unregistered
            st.inflight += 1
            st.sync_ops += 1
        self.on_complete(source, latency_s, nbytes,
                         CompletionState.DONE if ok
                         else CompletionState.ERROR)

    # -- polling ---------------------------------------------------------
    def poll_once(self) -> int:
        """Drive every polled source once; returns how many were polled.
        Waiters normally drive their own source; this is the whole-plane
        sweep (used by drains and tests)."""
        with self._lock:
            pollers = list(self._pollers.values())
        for p in pollers:
            p()
        return len(pollers)

    # -- telemetry -------------------------------------------------------
    def stats_for(self, source: str) -> Optional[SourceTelemetry]:
        with self._lock:
            st = self._sources.get(source)
            return st.snapshot() if st is not None else None

    def stats_many(self, sources: Iterable[str]
                   ) -> Dict[str, SourceTelemetry]:
        """Consistent snapshot of several sources under ONE lock
        acquisition (unknown sources are simply absent).  Callers that
        compare sources — the selector's measured scoring, the fabric
        manager's median-relative health check — must use this rather
        than per-source ``stats_for`` loops, or the comparison mixes
        points in time."""
        with self._lock:
            return {s: self._sources[s].snapshot() for s in sources
                    if s in self._sources}

    @staticmethod
    def _as_dict(s: SourceTelemetry) -> dict:
        return {"mode": s.mode, "submitted": s.submitted,
                "completed": s.completed, "errors": s.errors,
                "cancelled": s.cancelled, "inflight": s.inflight,
                "bytes_moved": s.bytes_moved,
                "ewma_latency_s": s.ewma_latency_s,
                "ewma_nbytes": s.ewma_nbytes,
                "ewma_gbps": s.ewma_gbps,
                "last_latency_s": s.last_latency_s,
                "total_latency_s": s.total_latency_s,
                "sync_ops": s.sync_ops}

    def source_telemetry(self, source: str) -> Optional[dict]:
        """One source's counters as a dict — the O(1) lookup stats()
        consumers want (``telemetry()`` walks every source)."""
        st = self.stats_for(source)
        return self._as_dict(st) if st is not None else None

    def telemetry(self) -> Dict[str, dict]:
        """Snapshot of every source's counters (for stats()/benches).
        All sources are captured under ONE lock acquisition, so the
        returned dict is a single consistent point in time — cross-source
        comparisons (fleet medians, share-of-traffic) are meaningful."""
        with self._lock:
            snaps = {n: st.snapshot() for n, st in self._sources.items()}
        return {n: self._as_dict(s) for n, s in snaps.items()}


_DEFAULT = Reactor()


def default_reactor() -> Reactor:
    """The process-wide reactor every source binds to by default."""
    return _DEFAULT
