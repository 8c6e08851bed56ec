"""Cold-tier backends for the tiered store.

Twin of ``repro/rmem/backend.py``.  A ``TierBackend`` is where cold
pages live — the axis the paper varies: host DRAM over PCIe DMA vs
NIC-attached DRAM over RDMA-style verbs.  The hot tier (device memory)
and the staging path are owned by ``TieredStore``; backends only store
and load fixed-size byte pages and account their tier's traffic.

``LocalHostBackend`` — pages in host RAM: the paper's XDMA/QDMA pattern;
cold-tier store/load is a host memcpy and all link cost sits on the
H2C/C2H leg.

``RemoteBackend`` — pages on one or more ``MemoryNode``s reached through
a ``QueuePair`` with doorbell batching: the paper's RDMA pattern; every
store is a one-sided write and every load a one-sided read.

Both report measured seconds plus *projected* seconds on their
analytical path model (``core/analytical.py``: ``h100_host_path`` and
``far_memory_path``).  The batched surface (``load_many``/``store_many``
and the ``*_async`` variants returning ``PendingIO`` handles) is the
miss pipeline's foundation: ``RemoteBackend`` maps a page set onto read
or write doorbells (one completion fence per doorbell, node-side
coalescing into one staged hop), ``LocalHostBackend`` onto a single
vectorized row gather/scatter.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np

from repro_torch import obs
from repro_torch.core.analytical import (PathModel, doorbell_bandwidth_gbps,
                                         far_memory_path, h100_host_path)
from repro_torch.core.channels import CompletionMode, Direction
from repro_torch.cplane import Completion, CompletionState, CompletionTimeout
from repro_torch.faults import injector as _faults
from repro_torch.rmem.node import AddressMap, MemoryNode
from repro_torch.rmem.verbs import CompletionQueue, MemoryRegion, QueuePair


class PendingIO(Completion):
    """Handle for an in-flight batched tier operation — a thin
    ``cplane.Completion`` subclass.

    ``wait()`` blocks until the bytes have landed and returns the result —
    an ``(n, page_bytes)`` uint8 array for loads, ``None`` for stores.
    Idempotent: repeated waits return the same result.  Backends whose
    transfers complete inline (host memcpy) return already-finished
    handles, so callers pipeline uniformly over any tier.

    Two construction modes:

    * ``PendingIO(finalize, deps=[...])`` — *reactive*: ``deps`` are the
      completions of the underlying work (doorbells, member IOs).  When
      the last dep settles, this handle settles too, with the result
      produced lazily by ``finalize`` on the first consumer — so it
      composes with ``wait_any``/``as_completed`` and ``poll()`` answers
      without blocking (what serve's decode/paging overlap needs).
    * ``PendingIO(finalize)`` — legacy *eager* mode for backends that
      cannot expose readiness: ``wait`` runs ``finalize(timeout)`` on
      the waiting thread, exactly the old contract.

    Timeouts are uniform across both modes and every backend: expiry
    raises ``cplane.CompletionTimeout`` (a ``TimeoutError`` subclass),
    never a backend-specific exception, and the handle stays waitable.
    """

    def __init__(self, finalize: Optional[Callable[[float], Any]] = None,
                 deps: Optional[Sequence[Completion]] = None,
                 source: Optional[str] = None, reactor=None,
                 nbytes: int = 0):
        super().__init__(source=source, reactor=reactor, nbytes=nbytes)
        self._finalize = finalize
        self._finalize_lock = threading.Lock()
        self._deps = list(deps) if deps is not None else None
        if self._deps is not None:
            if not self._deps:
                self._deps_ready()
            else:
                state = {"left": len(self._deps)}
                lock = threading.Lock()

                def dep_done(_c, state=state, lock=lock):
                    with lock:
                        state["left"] -= 1
                        last = state["left"] == 0
                    if last:
                        self._deps_ready()
                for d in self._deps:
                    d.add_callback(dep_done)

    @property
    def reactive(self) -> bool:
        """True when readiness propagates from deps (or the handle is
        already settled) — i.e. ``poll``/``wait_any`` work without a
        blocking finalize."""
        return self._deps is not None or self.poll()

    def _deps_ready(self) -> None:
        # every dep settled: the result is producible without blocking
        deps = self._deps or []
        failed = any(d.state is CompletionState.ERROR for d in deps)
        if self._finalize is None:
            if failed:
                self.fail(next(d.error for d in deps
                               if d.state is CompletionState.ERROR))
            else:
                self.succeed(None)
        elif failed:
            # a dep (doorbell/member IO) errored: run the finalizer NOW
            # (its fence won't block — deps are drained) so its cleanup
            # runs (deferred-error clearing, CQ drain) and this handle
            # settles ERROR — state/telemetry must not report DONE for
            # an operation that failed
            try:
                result = self._run_finalize(30.0)
            except BaseException as e:
                self.fail(e)
            else:               # finalizer tolerated the dep error
                self.succeed(result)
        else:
            self.succeed_lazy(lambda: self._run_finalize(30.0))

    def _run_finalize(self, timeout: float):
        try:
            return self._finalize(timeout)
        except CompletionTimeout:
            raise
        except TimeoutError as e:       # backend-specific timeout shapes
            raise CompletionTimeout(str(e)) from e

    def wait(self, timeout: float = 30.0):
        if self._deps is not None or self._finalize is None:
            return super().wait(timeout)
        # legacy eager mode: run the finalizer under this call's timeout;
        # on timeout the handle stays pending (retry keeps working)
        with self._finalize_lock:
            if not self.poll():
                try:
                    result = self._run_finalize(timeout)
                except CompletionTimeout:
                    raise
                except BaseException as e:
                    self.fail(e)
                    raise
                self.succeed(result)
        return self.result()

    @classmethod
    def ready(cls, result: Any = None) -> "PendingIO":
        io = cls()
        io.succeed(result)
        return io


@runtime_checkable
class TierBackend(Protocol):
    """Cold-tier page store: fixed-size byte pages keyed by index."""

    name: str
    n_pages: int
    page_bytes: int

    def store(self, page: int, value: np.ndarray) -> None:
        """Copy ``value`` (uint8, <= page_bytes) into cold storage."""
        ...

    def load(self, page: int) -> np.ndarray:
        """Return the page's bytes (uint8 view/copy, page_bytes long)."""
        ...

    def store_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        """Store a batch of full pages in one amortized operation."""
        ...

    def load_many(self, pages: Sequence[int]) -> np.ndarray:
        """Load a batch of pages; returns an (n, page_bytes) uint8 array."""
        ...

    def store_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        """Start a batched store; ``wait()`` fences it."""
        ...

    def load_many_async(self, pages: Sequence[int]) -> PendingIO:
        """Start a batched load; ``wait()`` returns the (n, page_bytes)
        array once every page's bytes have landed."""
        ...

    def path_model(self) -> PathModel:
        """Analytical model of this tier's link (for projections)."""
        ...

    def stats(self) -> dict:
        ...

    def close(self) -> None:
        ...


class _AccountingMixin:
    bytes_stored: int = 0
    bytes_loaded: int = 0
    store_ops: int = 0          # pages stored
    load_ops: int = 0           # pages loaded
    store_batches: int = 0      # amortized operations (1 per batched call)
    load_batches: int = 0
    seconds_busy: float = 0.0
    projected_s: float = 0.0    # accumulated target-link projection
    _reactor = None             # completion-plane telemetry (optional)
    _telemetry_source: Optional[str] = None

    def bind_telemetry(self, reactor, source: str) -> None:
        """Report this tier's per-call latency/bytes into a reactor
        source — how page-op EWMAs reach ``PathSelector``'s measured
        scoring (DESIGN.md §6)."""
        self._reactor = reactor
        self._telemetry_source = source
        reactor.register_source(source, mode="interrupt")

    def _account(self, nbytes: int, dt: float, is_store: bool,
                 n_ops: int = 1) -> None:
        if n_ops < 1:
            return
        if self._reactor is not None:
            self._reactor.record(self._telemetry_source, dt, nbytes)
        if is_store:
            self.bytes_stored += nbytes
            self.store_ops += n_ops
            self.store_batches += 1
        else:
            self.bytes_loaded += nbytes
            self.load_ops += n_ops
            self.load_batches += 1
        self.seconds_busy += dt
        # projection accrues per call: n_ops work requests of ~equal size
        # with the per-op setup amortized across the batch
        direction = Direction.H2C if is_store else Direction.C2H
        self.projected_s += self.projected_seconds(
            max(nbytes // n_ops, 1), n_ops, direction) * n_ops

    def projected_seconds(self, nbytes: int, batch: int = 1,
                          direction: Direction = Direction.C2H) -> float:
        """Time on the modeled target link (vs the measured container)."""
        bw = doorbell_bandwidth_gbps(self.path_model(), nbytes, batch,
                                     direction=direction)
        return nbytes / (bw * 1e9)

    def _base_stats(self) -> dict:
        # one nested schema shared with repro.access paths: the unified
        # {path, bytes_moved, ops, projected_s} keys first, then the
        # per-tier counters the benches/selector drill into; every
        # numeric leaf also mirrors into registry gauges under
        # ``backend.<name>.*`` when live metrics are on (the dict keys
        # stay as the aliases existing tests/benches read)
        return obs.export_stats(f"backend.{self.name}", {
            "path": self.name,
            "bytes_moved": self.bytes_stored + self.bytes_loaded,
            "ops": self.store_ops + self.load_ops,
            "projected_s": self.projected_s,
            "tier": self.name,
            "bytes_stored": self.bytes_stored,
            "bytes_loaded": self.bytes_loaded,
            "store_ops": self.store_ops,
            "load_ops": self.load_ops,
            "store_batches": self.store_batches,
            "load_batches": self.load_batches,
            "seconds_busy": self.seconds_busy})


class LocalHostBackend(_AccountingMixin):
    """Cold pages in host DRAM — the seed ``KVPager`` backing store."""

    name = "local-host"
    # fault-injection scopes: one per backend instance so a plan can
    # target one DMA engine without touching the rest (XDMA and QDMA
    # adapters both wrap instances of this class)
    _scope_ids = itertools.count()

    def __init__(self, n_pages: int, page_bytes: int):
        if n_pages < 1 or page_bytes < 1:
            raise ValueError((n_pages, page_bytes))
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        self.fault_scope = \
            f"{self.name}#{next(LocalHostBackend._scope_ids)}"
        self.mem = np.zeros((n_pages, page_bytes), np.uint8)

    def _inject(self, pages, bufs=None) -> None:
        """DMA-engine fault hook: one draw per page op, mirroring the
        per-WR draws on the verbs path; ``bufs`` are the just-landed
        destination rows (corruption targets)."""
        plan = _faults.current()
        if plan is None:
            return
        for i, _ in enumerate(pages):
            plan.before_op(self.fault_scope)
            if bufs is not None:
                plan.corrupt(self.fault_scope, bufs[i])

    def _check(self, page: int, nbytes: int) -> None:
        if page < 0 or page >= self.n_pages:
            raise IndexError(page)
        if nbytes > self.page_bytes:
            raise ValueError(f"{nbytes} B > page size {self.page_bytes}")

    def store(self, page: int, value: np.ndarray) -> None:
        flat = np.ascontiguousarray(value).reshape(-1).view(np.uint8)
        self._check(page, flat.size)
        t0 = time.perf_counter()
        self.mem[page, :flat.size] = flat
        if _faults.ACTIVE:
            self._inject([page], [self.mem[page, :flat.size]])
        self._account(flat.size, time.perf_counter() - t0, is_store=True)

    def load(self, page: int) -> np.ndarray:
        self._check(page, 0)
        t0 = time.perf_counter()
        out = self.mem[page].copy()
        if _faults.ACTIVE:
            self._inject([page], [out])
        self._account(out.size, time.perf_counter() - t0, is_store=False)
        return out

    # -- batched surface (vectorized row gather/scatter) -----------------
    def store_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        pages = list(pages)
        if len(pages) != len(values):
            raise ValueError(f"{len(pages)} pages vs {len(values)} values")
        flats = [np.ascontiguousarray(v).reshape(-1).view(np.uint8)
                 for v in values]
        for p, f in zip(pages, flats):
            self._check(p, f.size)
        t0 = time.perf_counter()
        if flats and all(f.size == self.page_bytes for f in flats):
            self.mem[np.asarray(pages, np.int64)] = np.stack(flats)
        else:
            for p, f in zip(pages, flats):
                self.mem[p, :f.size] = f
        if _faults.ACTIVE:
            self._inject(pages, [self.mem[p, :f.size]
                                 for p, f in zip(pages, flats)])
        self._account(sum(f.size for f in flats),
                      time.perf_counter() - t0, is_store=True,
                      n_ops=len(pages))

    def load_many(self, pages: Sequence[int]) -> np.ndarray:
        pages = list(pages)
        for p in pages:
            self._check(p, 0)
        t0 = time.perf_counter()
        if not pages:
            return np.empty((0, self.page_bytes), np.uint8)
        out = self.mem[np.asarray(pages, np.int64)]   # one row gather
        if _faults.ACTIVE:
            self._inject(pages, out)    # fancy-index gather is a copy:
            # a flip lands in the returned payload, not the store
        self._account(out.nbytes, time.perf_counter() - t0, is_store=False,
                      n_ops=len(pages))
        return out

    def store_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        self.store_many(pages, values)      # host memcpy completes inline
        return PendingIO.ready()

    def load_many_async(self, pages: Sequence[int]) -> PendingIO:
        return PendingIO.ready(self.load_many(pages))

    def path_model(self) -> PathModel:
        return h100_host_path()

    def stats(self) -> dict:
        return self._base_stats()

    def close(self) -> None:
        pass


class RemoteBackend(_AccountingMixin):
    """Cold pages on far-memory nodes via one-sided verbs.

    The page address space ``[0, n_pages * page_bytes)`` is striped across
    the given nodes by an ``AddressMap`` (nodes are created if omitted).  A
    single staging ``MemoryRegion`` (one slot per page) feeds the QP, so a
    re-store to the same page before its doorbell fires is plain write
    combining, never a torn buffer.  ``device`` is where the nodes it
    creates land their link hop (default ``cuda``).
    """

    name = "remote"

    def __init__(self, n_pages: int, page_bytes: int,
                 nodes: Optional[Sequence[MemoryNode]] = None,
                 n_nodes: int = 1, doorbell_batch: int = 1,
                 mode: CompletionMode = CompletionMode.POLLED,
                 node_latency_s: float = 0.0, device=None):
        if n_pages < 1 or page_bytes < 1:
            raise ValueError((n_pages, page_bytes))
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        total = n_pages * page_bytes
        self._own_nodes = nodes is None
        if nodes is None:
            per = -(-total // max(n_nodes, 1)) + 4096
            nodes = [MemoryNode(f"memnode{i}", per, device=device,
                                latency_s=node_latency_s)
                     for i in range(n_nodes)]
        self.amap = AddressMap.striped(list(nodes), total,
                                       align=min(page_bytes, 4096))
        self.cq = CompletionQueue(mode)
        self.qp = QueuePair(self.amap, self.cq, doorbell_batch=doorbell_batch)
        self._staging = np.zeros((n_pages, page_bytes), np.uint8)
        self.mr = MemoryRegion(self._staging)
        self.doorbell_batch = doorbell_batch

    def bind_telemetry(self, reactor, source: str) -> None:
        """Point both this tier's per-call records AND the QP's doorbell
        completions at ``source``, so the selector's measured term sees
        outstanding verbs work as in-flight ops."""
        super().bind_telemetry(reactor, source)
        self.qp.bind_telemetry(reactor, source)

    def _check(self, page: int, nbytes: int) -> None:
        if page < 0 or page >= self.n_pages:
            raise IndexError(page)
        if nbytes > self.page_bytes:
            raise ValueError(f"{nbytes} B > page size {self.page_bytes}")

    def _drain_cq(self) -> None:
        """Discard accumulated completions.  The batched paths fence on
        doorbells directly, so without this the signaled-WR completions
        would pile up in the ring unboundedly (the sync ``load`` drains it
        as a side effect of ``wait_wr``)."""
        while self.cq.poll(256):
            pass

    def store(self, page: int, value: np.ndarray) -> None:
        flat = np.ascontiguousarray(value).reshape(-1).view(np.uint8)
        self._check(page, flat.size)
        t0 = time.perf_counter()
        self._staging[page, :flat.size] = flat
        self.qp.post_write(self.mr, page * self.page_bytes,
                           page * self.page_bytes, self.page_bytes)
        # doorbell rings at batch depth; flush() is the explicit fence
        if _faults.ACTIVE:
            # under injection an unfenced store can die node-side after
            # this call returns — a deferred error the retry wrapper
            # (which still holds the value) would never see, turning a
            # transient into silent loss.  Fence here so the failure
            # surfaces to whoever can re-store the page.
            self.qp.flush()
        self._account(flat.size, time.perf_counter() - t0, is_store=True)

    def load(self, page: int) -> np.ndarray:
        self._check(page, 0)
        t0 = time.perf_counter()
        # conditional fence: flush() is a no-op fast path (that still
        # surfaces deferred async errors) unless WRs are outstanding
        self.qp.flush()
        self.qp.read(self.mr, page * self.page_bytes,
                     page * self.page_bytes, self.page_bytes)
        out = self._staging[page].copy()
        self._account(out.size, time.perf_counter() - t0, is_store=False)
        return out

    # -- batched surface (doorbell-batched verbs) ------------------------
    def store_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        """Batched stores: writes accumulate into doorbells at the QP's
        batch depth; like ``store``, the final partial doorbell stays
        pending for write combining (``flush()`` or a later load fences)."""
        pages = list(pages)
        if len(pages) != len(values):
            raise ValueError(f"{len(pages)} pages vs {len(values)} values")
        t0 = time.perf_counter()
        total = 0
        for p, v in zip(pages, values):
            flat = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
            self._check(p, flat.size)
            self._staging[p, :flat.size] = flat
            self.qp.post_write(self.mr, p * self.page_bytes,
                               p * self.page_bytes, self.page_bytes)
            total += flat.size
        if _faults.ACTIVE:
            # same deferred-loss hazard as ``store``: fence the batch so
            # an injected write failure is raised to the caller, who can
            # re-issue the whole batch (staging rows are rewritten on
            # every attempt, so replay is idempotent)
            self.qp.flush()
        self._account(total, time.perf_counter() - t0, is_store=True,
                      n_ops=len(pages))

    def store_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        """Batched stores with a completion handle: rings the tail doorbell
        so the batch can drain, ``wait()`` fences exactly these writes."""
        pages = list(pages)
        with self.qp.collect_doorbells() as coll:
            self.store_many(pages, values)
            self.qp.ring_doorbell()

        def finalize(timeout: float):
            coll.wait(timeout)
            self.qp.raise_deferred()
            self._drain_cq()
            return None
        # reactive handle: readiness propagates from the bells' own
        # completions, so poll()/wait_any see the batch land without a
        # blocking fence
        return PendingIO(finalize, deps=coll.completions())

    def load_many(self, pages: Sequence[int]) -> np.ndarray:
        return self.load_many_async(pages).wait()

    def load_many_async(self, pages: Sequence[int]) -> PendingIO:
        """Doorbell-batched reads with completion-carried delivery.

        Reads are posted back-to-back (accumulating into doorbells at the
        QP's batch depth, coalesced node-side into one staged hop per
        doorbell) and the tail doorbell is rung immediately; no QP-wide
        flush — FIFO execution per node already orders these reads after
        any writes posted earlier on this QP, including same-doorbell
        writes.  ``wait()`` fences only this call's doorbells, then gathers
        the landed staging rows.
        """
        pages = list(pages)
        for p in pages:
            self._check(p, 0)
        t0 = time.perf_counter()
        with self.qp.collect_doorbells() as coll:
            for p in pages:
                self.qp.post_read(self.mr, p * self.page_bytes,
                                  p * self.page_bytes, self.page_bytes)
            self.qp.ring_doorbell()
        t_issued = time.perf_counter()

        def finalize(timeout: float):
            if not pages:
                return np.empty((0, self.page_bytes), np.uint8)
            t_join = time.perf_counter()
            coll.wait(timeout)
            self.qp.raise_deferred()
            self._drain_cq()
            out = self._staging[np.asarray(pages, np.int64)]  # row gather
            # busy time = issue cost + time blocked joining; the caller's
            # think-time between issue and join (the prefetch overlap win)
            # is explicitly NOT charged to the tier
            dt = (t_issued - t0) + (time.perf_counter() - t_join)
            self._account(out.nbytes, dt, is_store=False, n_ops=len(pages))
            return out
        return PendingIO(finalize, deps=coll.completions(),
                         nbytes=len(pages) * self.page_bytes)

    def flush(self) -> None:
        self.qp.flush()

    def path_model(self) -> PathModel:
        return far_memory_path()

    def stats(self) -> dict:
        s = self._base_stats()
        s["qp"] = self.qp.stats()
        s["nodes"] = [n.stats() for n in self.amap.nodes]
        return s

    def close(self) -> None:
        try:
            self.qp.flush()
        finally:
            # drop this backend's reactor sources (the QP's — possibly
            # rebound to an adapter's ':page' name the adapter also
            # cleans — and the explicitly-owned CQ's)
            self.qp.close()
            self.cq.close()
            if self._own_nodes:
                for n in self.amap.nodes:
                    n.close()


def make_backend(kind: str, n_pages: int, page_bytes: int,
                 **kw) -> TierBackend:
    """Factory used by CLI flags (``--kv-backend local|remote``)."""
    if kind in ("local", "local-host", "host"):
        return LocalHostBackend(n_pages, page_bytes)
    if kind == "remote":
        return RemoteBackend(n_pages, page_bytes, **kw)
    raise ValueError(f"unknown tier backend {kind!r}")
