"""Queue-based transfer engine (the QDMA model).

QDMA manages transfers through *descriptor queues* assigned to PCIe
physical/virtual functions rather than fixed channels (PG302, derived from
RDMA queue pairs).  Here a ``FunctionQueue`` is a bounded descriptor ring
owned by one logical "function" (a tenant / subsystem: data pipeline,
checkpointer, KV pager...).  A scheduler thread drains queues with weighted
round-robin onto a shared ``ChannelPool`` — dynamic multi-stream management
vs XDMA's static channels, matching the paper's §4.1.2 contrast.

Twin of ``repro/core/queues.py``.  On a CUDA pool the scheduler thread
submits on behalf of another thread, so each ``WorkItem`` carries the
submitter's current stream and the scheduler submits under it: the
pool's channels then order their copies after the work the submitter
queued before it (a C2H reads what that work wrote), exactly as a direct
``ChannelPool.submit`` from the submitter's thread would.  An idle
scheduler sleeps until an enqueue wakes it, where the reference's polls
every 0.2 ms: on the card the serve path is bound by the host thread
that issues kernels, and a thread taking the interpreter lock 5,000
times a second slows every decode step.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.core.channels import (ChannelPool, CompletionMode,
                                       Direction, Transfer)
from repro_torch.cplane import Completion


@dataclass
class WorkItem:
    """One queued descriptor.  ``assigned`` settles (with the attached
    ``Transfer``) when the scheduler dispatches it to a channel; ``done``
    settles when the transfer finishes — both are ``cplane.Completion``s,
    so work items compose with any other async primitive via
    ``wait_any``/``wait_all``."""

    payload: Any
    direction: Direction
    transfer: Optional[Transfer] = None
    done: Completion = field(default_factory=Completion)
    assigned: Completion = field(default_factory=Completion)
    stream: Optional[torch.cuda.Stream] = None   # the submitter's (CUDA)


class FunctionQueue:
    """Bounded descriptor ring for one logical function (PF/VF analogue)."""

    def __init__(self, name: str, depth: int = 64, weight: int = 1,
                 wake: Optional[threading.Event] = None):
        self.name = name
        self._wake = wake           # set on every enqueue (the scheduler)
        self.depth = depth
        self.weight = weight
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0

    def enqueue(self, item: WorkItem, block: bool = True,
                timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if len(self._ring) < self.depth:
                    self._ring.append(item)
                    self.submitted += 1
                    if self._wake is not None:
                        self._wake.set()
                    return True
            if not block:
                return False
            if time.monotonic() > deadline:
                raise TimeoutError(f"queue {self.name} full")
            time.sleep(0.0005)

    def _pop(self) -> Optional[WorkItem]:
        with self._lock:
            return self._ring.popleft() if self._ring else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class QueueEngine:
    """Weighted round-robin scheduler over function queues."""

    def __init__(self, pool: Optional[ChannelPool] = None,
                 n_channels: int = 4, owns_pool: Optional[bool] = None,
                 device=None):
        """``owns_pool`` makes pool lifetime explicit: the engine closes
        the pool on ``close()`` iff it owns it.  Default: own a pool we
        created, never one handed in (shared pools have another owner).
        ``device`` places a pool the engine creates (default ``cuda``)."""
        self.pool = pool if pool is not None else \
            ChannelPool(n_channels, device=device)
        self.owns_pool = (pool is None) if owns_pool is None else \
            bool(owns_pool)
        self._closed = False
        self.queues: Dict[str, FunctionQueue] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()      # an enqueue since the last round
        self._thread = threading.Thread(target=self._scheduler, daemon=True,
                                        name="nma-qdma-sched")
        self._thread.start()

    def create_queue(self, name: str, depth: int = 64,
                     weight: int = 1) -> FunctionQueue:
        with self._lock:
            if name in self.queues:
                raise ValueError(f"queue {name!r} exists")
            q = FunctionQueue(name, depth, weight, wake=self._work)
            self.queues[name] = q
            return q

    def submit(self, qname: str, payload, direction: Direction) -> WorkItem:
        item = WorkItem(payload, direction)
        if self.pool.device.type == "cuda":
            item.stream = torch.cuda.current_stream(self.pool.device)
        self.queues[qname].enqueue(item)
        return item

    def _scheduler(self) -> None:
        while not self._stop.is_set():
            # clear before the round: an enqueue during it sets the event
            # again, so the wait below returns at once and nothing is lost
            self._work.clear()
            if not self._drain_once():
                self._work.wait(0.05)

    def _drain_once(self) -> bool:
        """One weighted-RR round: up to ``weight`` items per queue."""
        moved = False
        with self._lock:
            qs = list(self.queues.values())
        for q in qs:
            for _ in range(q.weight):
                item = q._pop()
                if item is None:
                    break
                moved = True

                def fire(tr, item=item, q=q):
                    q.completed += 1
                    item.done.succeed(tr)

                try:
                    if item.stream is not None:
                        with torch.cuda.stream(item.stream):
                            item.transfer = self._submit(item, fire)
                    else:
                        item.transfer = self._submit(item, fire)
                except Exception as e:    # surface it to the submitter
                    item.assigned.fail(e)
                    item.done.fail(e)
                    continue
                item.assigned.succeed(item.transfer)
        return moved

    def _submit(self, item: WorkItem, fire) -> Transfer:
        return self.pool.submit(item.payload, item.direction,
                                mode=CompletionMode.INTERRUPT,
                                on_complete=fire)

    def wait(self, item: WorkItem, timeout: float = 60.0):
        """Block on the item's ``done`` completion (raises
        ``cplane.CompletionTimeout``, a ``TimeoutError``), then surface
        the transfer's result/error."""
        item.done.wait(timeout)
        return item.transfer.result()

    def close(self) -> None:
        """Idempotent: a second close is a no-op (double-close used to
        re-close a shared pool when ownership was ambiguous)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=5)
        if self.owns_pool:
            self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
