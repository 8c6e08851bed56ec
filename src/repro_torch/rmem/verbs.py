"""RDMA-style one-sided verbs onto far memory.

Twin of ``repro/rmem/verbs.py``: the paper's third access design, an
easy API over a separate link, as a verbs surface:

* ``MemoryRegion`` — registration of a host buffer (lkey, byte-addressable
  view), the prerequisite for any one-sided op;
* ``QueuePair`` — posts one-sided READ/WRITE work requests against a
  ``MemoryNode`` (or an ``AddressMap`` spanning several nodes), with
  *doorbell batching*: posts accumulate until ``ring_doorbell()`` (or the
  configured batch depth) and only the last WR of a doorbell is signaled,
  so N batched writes cost one completion and one setup latency;
* ``CompletionQueue`` — POLLED (caller polls/waits) or INTERRUPT (callback
  from the node's completion path) via the shared ``CompletionMode``.

Every executed WR crosses its node's link hop (``rmem/node.py``: a copy
onto the node's torch device and back) before bytes land in the node's
pool.  Under an installed ``FaultPlan`` completion delivery may lag
(``plan.delay`` on the completion queue's source, the straggler hook).
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channels import CompletionMode
from repro_torch.cplane import Completion, CompletionTimeout, default_reactor
from repro_torch.faults import injector as _faults


class OpCode(enum.Enum):
    READ = "read"
    WRITE = "write"


class WCStatus(enum.Enum):
    SUCCESS = "success"
    ERROR = "error"


class MemoryRegion:
    """Registered host buffer: the lkey-bearing byte view verbs operate on."""

    _lkeys = itertools.count(1)

    def __init__(self, buf: np.ndarray):
        if not isinstance(buf, np.ndarray):
            raise TypeError("MemoryRegion requires a host numpy buffer")
        self.buf = buf
        self._view = buf.reshape(-1).view(np.uint8)
        self.lkey = next(self._lkeys)

    @property
    def nbytes(self) -> int:
        return self._view.size

    def view(self, offset: int, nbytes: int) -> np.ndarray:
        if offset < 0 or nbytes < 0 or offset + nbytes > self.nbytes:
            raise ValueError(f"MR access out of bounds: "
                             f"[{offset}, {offset + nbytes}) vs {self.nbytes}")
        return self._view[offset:offset + nbytes]


@dataclass
class WorkCompletion:
    wr_id: int
    opcode: OpCode
    status: WCStatus
    nbytes: int                 # bytes of the signaled WR itself
    batch_bytes: int            # bytes of the whole doorbell it closed
    batch_wrs: int              # WRs in that doorbell
    t_post: float
    t_done: float
    error: Optional[Exception] = None

    @property
    def seconds(self) -> float:
        return max(self.t_done - self.t_post, 1e-9)

    @property
    def gbps(self) -> float:
        return self.batch_bytes / self.seconds / 1e9


class CompletionQueue:
    """Completion ring on the completion plane.

    POLLED callers poll/wait, INTERRUPT fires a callback — unchanged.
    Blocked consumers are now ``cplane.Completion`` waiters over the
    ring: ``push`` satisfies them (interrupt delivery) and, in POLLED
    mode, the waiter's own thread drives ``_satisfy`` as its completion
    poller, so the CQ is registered with the reactor as a *polled*
    source.  Timeouts raise ``cplane.CompletionTimeout`` (a
    ``TimeoutError`` subclass).
    """

    _ids = itertools.count(1)

    def __init__(self, mode: CompletionMode = CompletionMode.POLLED,
                 on_completion: Optional[Callable[[WorkCompletion], None]] = None,
                 reactor=None):
        self.mode = mode
        self.on_completion = on_completion
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self._waiters: List[CompletionQueue._Waiter] = []
        self.n_completions = 0
        self._reactor = reactor if reactor is not None else default_reactor()
        self.source = f"verbs-cq{next(CompletionQueue._ids)}"
        self._reactor.register_source(
            self.source, mode="polled" if mode == CompletionMode.POLLED
            else "interrupt")

    def close(self) -> None:
        """Drop the reactor source (telemetry for an owned CQ dies with
        its owner — long-lived processes must not accumulate one entry
        per queue ever constructed)."""
        self._reactor.unregister_source(self.source)

    class _Waiter:
        """One blocked consumer: a take-predicate over the ring plus the
        completion its thread blocks on."""

        def __init__(self, cq: "CompletionQueue", n: Optional[int] = None,
                     wr_id: Optional[int] = None):
            self.n = n
            self.wr_id = wr_id
            self.got: List[WorkCompletion] = []
            poller = cq._satisfy if cq.mode == CompletionMode.POLLED \
                else None
            self.completion = Completion(source=cq.source,
                                         reactor=cq._reactor,
                                         poller=poller)

        def take(self, ring: deque) -> bool:
            """Consume what this waiter needs from the ring (called under
            the CQ lock); True once satisfied."""
            if self.wr_id is None:
                while ring and len(self.got) < self.n:
                    self.got.append(ring.popleft())
                return len(self.got) >= self.n
            while ring:
                wc = ring.popleft()
                if wc.wr_id == self.wr_id:
                    self.got.append(wc)
                    return True
            return False

    def push(self, wc: WorkCompletion) -> None:
        if _faults.ACTIVE:
            plan = _faults.current()
            if plan is not None:
                # straggler-only: completion delivery can lag (the NIC
                # event path stalls the characterization papers report),
                # but never fails an already-executed WR
                plan.delay(self.source)
        with self._lock:
            self._ring.append(wc)
            self.n_completions += 1
        if self.mode == CompletionMode.INTERRUPT and \
                self.on_completion is not None:
            self.on_completion(wc)
        self._satisfy()

    def _satisfy(self) -> None:
        """Hand ring entries to blocked waiters, FIFO, settling every
        waiter whose predicate is now met.  Runs from ``push`` (interrupt
        delivery) and from polled waiters' own threads."""
        settled = []
        with self._lock:
            for w in list(self._waiters):
                if w.take(self._ring):
                    self._waiters.remove(w)
                    settled.append(w)
        for w in settled:
            w.completion.succeed(w.got if w.wr_id is None else w.got[0])

    def poll(self, max_entries: int = 16) -> List[WorkCompletion]:
        out = []
        with self._lock:
            while self._ring and len(out) < max_entries:
                out.append(self._ring.popleft())
        return out

    def _block_on(self, waiter: "_Waiter", timeout: float, describe) \
            -> object:
        with self._lock:
            self._waiters.append(waiter)
        self._satisfy()                 # entries may already be waiting
        try:
            return waiter.completion.wait(timeout)
        except CompletionTimeout:
            with self._lock:
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
            # settle the abandoned waiter so its on_submit telemetry is
            # balanced — else every timeout inflates the source's
            # in-flight gauge forever
            if not waiter.completion.cancel():
                # a racing _satisfy settled it between our timeout and
                # the cancel: delivery won — hand over its entries
                # rather than dropping popped completions on the floor
                return waiter.completion.result()
            msg = describe(waiter)
            if waiter.got:
                # return partially-consumed entries to the ring head so
                # a retry (or another waiter) still sees them
                with self._lock:
                    self._ring.extendleft(reversed(waiter.got))
            raise CompletionTimeout(msg) from None

    def wait(self, n: int = 1, timeout: float = 30.0) -> List[WorkCompletion]:
        """Block until ``n`` completions are available, then pop them."""
        return self._block_on(
            self._Waiter(self, n=n), timeout,
            lambda w: f"CQ: {len(w.got)}/{n} completions before timeout")

    def wait_wr(self, wr_id: int, timeout: float = 30.0) -> WorkCompletion:
        """Block until the completion for ``wr_id`` arrives; pops others too
        (they stay drained — the caller asked for a specific fence)."""
        return self._block_on(
            self._Waiter(self, wr_id=wr_id), timeout,
            lambda w: f"CQ: wr {wr_id} incomplete")


@dataclass
class WorkRequest:
    wr_id: int
    opcode: OpCode
    mr: MemoryRegion
    local_offset: int
    remote_addr: int            # virtual address (AddressMap space)
    nbytes: int
    signaled: bool
    t_post: float = 0.0
    # filled by routing: physical placement on one node
    phys_addr: int = 0


class _Doorbell:
    """One rung doorbell: a batch of routed WRs sharing a completion fence.

    The signaled WR's completion is deferred until every WR of the batch
    (possibly split across nodes by the AddressMap) has executed — the
    'only the last WR is signaled' RDMA idiom.  The fence is a
    ``cplane.Completion`` (``self.completion``) settled from the node
    thread on drain, so async backend paths — and heterogeneous
    ``wait_any`` racers — fence on exactly this batch without touching
    the CQ (completion-carried delivery: when the bell settles, every
    READ's payload has already landed in its MR).  Its latency/bytes
    feed the owning QP's reactor source.
    """

    def __init__(self, wrs: Sequence[WorkRequest], cq: CompletionQueue,
                 on_drained: Optional[Callable[["_Doorbell"], None]] = None,
                 reactor=None, source: Optional[str] = None):
        self.cq = cq
        self.on_drained = on_drained
        self.remaining = len(wrs)
        self.total_bytes = sum(w.nbytes for w in wrs)
        self.n_wrs = len(wrs)
        self.signaled = [w for w in wrs if w.signaled]
        self.error: Optional[Exception] = None
        self._lock = threading.Lock()
        self.completion = Completion(source=source, reactor=reactor,
                                     nbytes=self.total_bytes)

    def wr_done(self, wr: WorkRequest, error: Optional[Exception]) -> None:
        with self._lock:
            if error is not None and self.error is None:
                self.error = error
            self.remaining -= 1
            finished = self.remaining == 0
        if not finished:
            return
        t_done = time.perf_counter()
        for w in self.signaled:
            status = WCStatus.SUCCESS if self.error is None else WCStatus.ERROR
            self.cq.push(WorkCompletion(
                wr_id=w.wr_id, opcode=w.opcode, status=status,
                nbytes=w.nbytes, batch_bytes=self.total_bytes,
                batch_wrs=self.n_wrs, t_post=w.t_post, t_done=t_done,
                error=self.error))
        # QP bookkeeping (in-flight bells, deferred error) must settle
        # BEFORE waiters wake, or a waiter could observe — and fail to
        # clear — state that is still about to be written
        if self.on_drained is not None:
            self.on_drained(self)
        if self.error is not None:
            self.completion.fail(self.error)
        else:
            self.completion.succeed(None)

    def wait(self, timeout: float = 30.0) -> None:
        """Block until every WR of this doorbell has executed; raises the
        first WR error if any."""
        try:
            self.completion.wait(timeout)
        except CompletionTimeout:
            raise CompletionTimeout(
                f"doorbell: {self.remaining}/{self.n_wrs} WRs in flight"
            ) from None


class QueuePair:
    """Send queue of one-sided verbs against a node or an address map.

    ``target`` is a ``MemoryNode`` (single-node rmem) or an ``AddressMap``
    (SimBricks-memswitch-style multi-node far memory).  Work requests
    accumulate until ``ring_doorbell()``; posting the ``doorbell_batch``-th
    WR rings automatically.  Only the final WR of each doorbell is signaled
    unless the caller forces ``signaled=True``.
    """

    _qpns = itertools.count(1)

    def __init__(self, target, cq: Optional[CompletionQueue] = None,
                 doorbell_batch: int = 1,
                 mode: CompletionMode = CompletionMode.POLLED,
                 reactor=None):
        if doorbell_batch < 1:
            raise ValueError(
                f"doorbell_batch must be >= 1, got {doorbell_batch}")
        self.target = target
        self._own_cq = cq is None
        self.cq = cq if cq is not None else CompletionQueue(mode)
        self.doorbell_batch = doorbell_batch
        self.qpn = next(self._qpns)
        self._pending: List[WorkRequest] = []
        self._wr_ids = itertools.count(1)
        self._state_lock = threading.Lock()
        self._bells: List[_Doorbell] = []   # rung, not yet drained
        # deferred async errors, one slot PER drained bell (insertion-
        # ordered): each error is raised or consumed exactly once, and a
        # second failed bell is never silently lost behind the first
        self._async_errors: Dict[int, Exception] = {}
        self._collectors: List[List[_Doorbell]] = []
        # completion-plane source: doorbell latencies/bytes feed its EWMAs
        self._reactor = reactor if reactor is not None else default_reactor()
        self.source = f"verbs-qp{self.qpn}"
        self._reactor.register_source(self.source, mode="interrupt")
        # accounting (per-tier bandwidth/latency bookkeeping)
        self.bytes_written = 0
        self.bytes_read = 0
        self.doorbells = 0
        self.wrs_posted = 0

    def bind_telemetry(self, reactor, source: str) -> None:
        """Re-point doorbell telemetry at ``source`` (how an access-path
        adapter claims this QP's in-flight/latency EWMAs)."""
        self._reactor.unregister_source(self.source)
        self._reactor = reactor
        self.source = source
        reactor.register_source(source, mode="interrupt")

    # -- posting ---------------------------------------------------------
    def _post(self, opcode: OpCode, mr: MemoryRegion, local_offset: int,
              remote_addr: int, nbytes: int, wr_id: Optional[int],
              signaled: Optional[bool]) -> int:
        mr.view(local_offset, nbytes)  # bounds-check at post time
        wr = WorkRequest(
            wr_id=wr_id if wr_id is not None else next(self._wr_ids),
            opcode=opcode, mr=mr, local_offset=local_offset,
            remote_addr=remote_addr, nbytes=nbytes,
            signaled=bool(signaled) if signaled is not None else False)
        self._pending.append(wr)
        self.wrs_posted += 1
        if opcode == OpCode.WRITE:
            self.bytes_written += nbytes
        else:
            self.bytes_read += nbytes
        if len(self._pending) >= self.doorbell_batch:
            self.ring_doorbell()
        return wr.wr_id

    def post_write(self, mr: MemoryRegion, local_offset: int,
                   remote_addr: int, nbytes: int,
                   wr_id: Optional[int] = None,
                   signaled: Optional[bool] = None) -> int:
        return self._post(OpCode.WRITE, mr, local_offset, remote_addr,
                          nbytes, wr_id, signaled)

    def post_read(self, mr: MemoryRegion, local_offset: int,
                  remote_addr: int, nbytes: int,
                  wr_id: Optional[int] = None,
                  signaled: Optional[bool] = None) -> int:
        return self._post(OpCode.READ, mr, local_offset, remote_addr,
                          nbytes, wr_id, signaled)

    # -- doorbell --------------------------------------------------------
    def _route(self, wrs: Sequence[WorkRequest]) \
            -> List[Tuple["object", List[WorkRequest]]]:
        """Resolve virtual addresses; split WRs spanning node boundaries."""
        from repro_torch.rmem.node import AddressMap, MemoryNode
        routed: List[Tuple[object, WorkRequest]] = []
        for wr in wrs:
            if isinstance(self.target, MemoryNode):
                wr.phys_addr = wr.remote_addr
                routed.append((self.target, wr))
                continue
            amap: AddressMap = self.target
            for node, phys, nbytes, local_off in \
                    amap.resolve(wr.remote_addr, wr.nbytes):
                part = WorkRequest(
                    wr_id=wr.wr_id, opcode=wr.opcode, mr=wr.mr,
                    local_offset=wr.local_offset + local_off,
                    remote_addr=wr.remote_addr + local_off, nbytes=nbytes,
                    signaled=wr.signaled and
                    (local_off + nbytes == wr.nbytes),
                    t_post=wr.t_post, phys_addr=phys)
                routed.append((node, part))
        by_node: Dict[int, Tuple[object, List[WorkRequest]]] = {}
        for node, wr in routed:
            by_node.setdefault(id(node), (node, []))[1].append(wr)
        return list(by_node.values())

    def ring_doorbell(self) -> Optional[_Doorbell]:
        if not self._pending:
            return None
        wrs, self._pending = self._pending, []
        if not any(w.signaled for w in wrs):
            wrs[-1].signaled = True    # last-WR-signaled batching
        now = time.perf_counter()
        for w in wrs:
            w.t_post = now
        per_node = self._route(wrs)
        flat = [w for _, ws in per_node for w in ws]
        bell = _Doorbell(flat, self.cq, on_drained=self._bell_drained,
                         reactor=self._reactor, source=self.source)
        with self._state_lock:
            self._bells.append(bell)
        self.doorbells += 1
        for coll in self._collectors:
            coll.append(bell)
        for node, node_wrs in per_node:
            node.execute(node_wrs, bell)
        return bell

    class _BellCollector:
        """Context manager capturing every doorbell rung inside its scope
        (including auto-rings at batch depth) so async callers can fence on
        exactly their own WRs instead of flushing the whole QP."""

        def __init__(self, qp: "QueuePair"):
            self.qp = qp
            self.bells: List[_Doorbell] = []

        def __enter__(self) -> "QueuePair._BellCollector":
            self.qp._collectors.append(self.bells)
            return self

        def __exit__(self, *exc) -> None:
            self.qp._collectors.remove(self.bells)

        def wait(self, timeout: float = 30.0) -> None:
            try:
                for bell in self.bells:
                    bell.wait(timeout)
            except Exception:
                # these errors are reported here, to their own issuer —
                # consume every collected bell's deferred slot (not just
                # the one that raised: later bells of this batch may have
                # failed too, and their errors belong to this issuer, not
                # to whatever unrelated fence runs next).  Waiting the
                # same collector again re-raises from the bells' settled
                # completions, never from the QP — once-only is preserved
                # under retry wrapping.
                self.qp.consume_bell_errors(self.bells)
                raise

        def completions(self) -> List[Completion]:
            """The collected bells' completion handles — what async
            callers hand to ``cplane`` composition or ``PendingIO`` as
            readiness deps."""
            return [b.completion for b in self.bells]

    def collect_doorbells(self) -> "_BellCollector":
        return QueuePair._BellCollector(self)

    def raise_deferred(self) -> None:
        """Re-raise (once) the oldest async error from an already-drained
        doorbell.  Unsignaled WRs report failures this way — callers that
        skip the full fence still must not lose them.  Each deferred
        error is raised exactly once; further failed bells keep their own
        slots for the next call."""
        with self._state_lock:
            if not self._async_errors:
                return
            key = next(iter(self._async_errors))
            e = self._async_errors.pop(key)
        raise e

    def consume_bell_errors(self, bells: Sequence[_Doorbell]) -> None:
        """Discard the deferred slots of ``bells`` — called by whoever
        already observed (or owns) those bells' failures, so they are
        not re-raised to an unrelated later fence."""
        with self._state_lock:
            for b in bells:
                self._async_errors.pop(id(b), None)

    @property
    def outstanding_wrs(self) -> int:
        """Unfenced work: pending WRs (doorbell not rung) plus in-flight
        doorbells.  Zero means ``flush()`` would be a no-op — callers use
        this to fence conditionally instead of paying an unconditional
        flush on every access."""
        with self._state_lock:
            inflight = len(self._bells)
        return len(self._pending) + inflight

    def _bell_drained(self, bell: _Doorbell) -> None:
        with self._state_lock:
            if bell.error is not None:
                self._async_errors[id(bell)] = bell.error
            try:
                self._bells.remove(bell)
            except ValueError:
                pass

    # -- blocking convenience wrappers ----------------------------------
    def write(self, mr: MemoryRegion, local_offset: int, remote_addr: int,
              nbytes: int, timeout: float = 30.0) -> WorkCompletion:
        """Post + doorbell + wait: one synchronous one-sided write."""
        wr = self.post_write(mr, local_offset, remote_addr, nbytes,
                             signaled=True)
        self.ring_doorbell()
        wc = self.cq.wait_wr(wr, timeout)
        if wc.status != WCStatus.SUCCESS:
            raise wc.error or IOError(f"write wr {wr} failed")
        return wc

    def read(self, mr: MemoryRegion, local_offset: int, remote_addr: int,
             nbytes: int, timeout: float = 30.0) -> WorkCompletion:
        """Post + doorbell + wait: one synchronous one-sided read."""
        wr = self.post_read(mr, local_offset, remote_addr, nbytes,
                            signaled=True)
        self.ring_doorbell()
        wc = self.cq.wait_wr(wr, timeout)
        if wc.status != WCStatus.SUCCESS:
            raise wc.error or IOError(f"read wr {wr} failed")
        return wc

    def flush(self, timeout: float = 30.0) -> None:
        """Ring any pending doorbell and fence on ALL in-flight ones.

        Conditional on outstanding work: with nothing pending and nothing
        in flight it only re-raises a deferred async error (if any) and
        returns without ringing or waiting.  The fence waits on every
        in-flight bell's completion (re-snapshotting until the QP goes
        idle, so concurrently rung bells are fenced too); a failed bell's
        error is raised once the QP drains and cleared from the deferred
        slot."""
        if not self._pending:
            with self._state_lock:
                idle = not self._bells
            if idle:
                self.raise_deferred()
                return
        self.ring_doorbell()
        deadline = time.monotonic() + timeout
        first_err: Optional[BaseException] = None
        while True:
            with self._state_lock:
                bells = list(self._bells)
            if not bells:
                break
            for bell in bells:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CompletionTimeout(
                        f"flush: {len(bells)} doorbells in flight")
                try:
                    bell.completion.wait(left)
                except CompletionTimeout:
                    with self._state_lock:
                        n = len(self._bells)
                    raise CompletionTimeout(
                        f"flush: {n} doorbells in flight") from None
                except Exception as e:
                    if first_err is None:
                        first_err = e
        with self._state_lock:
            deferred = list(self._async_errors.values())
            self._async_errors.clear()
        if first_err is None and deferred:
            first_err = deferred[0]
        if first_err is not None:
            raise first_err

    def stats(self) -> dict:
        return {"bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "wrs_posted": self.wrs_posted,
                "doorbells": self.doorbells,
                "completions": self.cq.n_completions}

    def close(self) -> None:
        """Drop this QP's reactor source (and its owned CQ's) so churny
        short-lived QPs — per-checkpoint spills, bench sweeps — don't
        accumulate telemetry entries forever.  Does NOT fence: callers
        own their final ``flush()``."""
        self._reactor.unregister_source(self.source)
        if self._own_cq:
            self.cq.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
