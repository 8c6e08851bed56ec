"""``MemoryPath`` adapters over the access stacks.

Twin of ``repro/access/adapters.py`` for this slice: ``XdmaPath`` only —
static DMA channels (``ChannelPool``), pages in host DRAM, staging
submitted straight to the channels.  Low fixed setup per descriptor, no
cross-op coalescing: the raw-bandwidth path.  ``QdmaPath`` and
``VerbsPath`` are not ported yet.

Adapters are constructed by the registry (``access.registry``) either
*page-backed* (``n_pages``/``page_bytes`` given — usable as a cold tier)
or *stage-only* (``n_pages=0``).  All of them account into the unified
stats schema and report ``occupancy()``.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.access.path import (PathCapabilities, TierBackendCompat,
                                     unified_stats)
from repro_torch.core.analytical import h100_host_path
from repro_torch.core.channels import (ChannelPool, CompletionMode, Direction,
                                       Transfer)
from repro_torch.cplane import default_reactor
from repro_torch.rmem.backend import LocalHostBackend, PendingIO, TierBackend

_BOTH_MODES = (CompletionMode.POLLED, CompletionMode.INTERRUPT)


class _AdapterBase(TierBackendCompat):
    """Shared plumbing: page ops over a wrapped ``TierBackend``, stage-op
    accounting, occupancy from in-flight stage transfers, and the
    completion-plane telemetry binding: each adapter owns two reactor
    sources — ``<name>#<n>:page`` (cold-tier ops) and ``<name>#<n>:stage``
    (host<->device transfers) — whose latency/in-flight EWMAs feed
    ``PathSelector``'s measured scoring (DESIGN.md §6)."""

    name = "path"

    def __init__(self, backend: Optional[TierBackend],
                 caps: PathCapabilities, reactor=None):
        self.backend = backend
        self._caps = caps
        self.n_pages = backend.n_pages if backend is not None else 0
        self.page_bytes = backend.page_bytes if backend is not None else 0
        self.stage_bytes = 0
        self.stage_ops = 0
        self._stage_projected_s = 0.0
        self._inflight: deque = deque()     # unfinished stage Transfers
        self._lock = threading.Lock()
        self._closed = False
        self.reactor = reactor if reactor is not None else default_reactor()
        stem = self.reactor.unique_source(self.name)
        self._page_source = f"{stem}:page"
        self._stage_source = f"{stem}:stage"
        if backend is not None:
            backend.bind_telemetry(self.reactor, self._page_source)
        pool = getattr(self, "pool", None)
        if pool is not None:
            pool.bind_telemetry(self.reactor, self._stage_source)

    def telemetry_source(self, stage: bool = False) -> str:
        """The reactor source this adapter's ops report into."""
        return self._stage_source if stage else self._page_source

    def capabilities(self) -> PathCapabilities:
        return self._caps

    # -- page ops --------------------------------------------------------
    def _require_pages(self) -> TierBackend:
        if self.backend is None:
            raise RuntimeError(
                f"{self.name} path is stage-only (n_pages=0); construct it "
                f"with page geometry to use page ops")
        return self.backend

    def write(self, page: int, value: np.ndarray) -> None:
        self._require_pages().store(page, value)

    def read(self, page: int) -> np.ndarray:
        return self._require_pages().load(page)

    def write_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        self._require_pages().store_many(pages, values)

    def read_many(self, pages: Sequence[int]) -> np.ndarray:
        return self._require_pages().load_many(pages)

    def write_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        return self._require_pages().store_many_async(pages, values)

    def read_many_async(self, pages: Sequence[int]) -> PendingIO:
        return self._require_pages().load_many_async(pages)

    # -- stage ops -------------------------------------------------------
    def _submit_stage(self, payload, direction: Direction,
                      on_complete, qname: str) -> Transfer:
        raise NotImplementedError

    def _stage(self, payload, direction: Direction, on_complete,
               qname: str) -> Transfer:
        tr = self._submit_stage(payload, direction, on_complete, qname)
        nbytes = int(getattr(payload, "nbytes", 0))
        with self._lock:
            self.stage_bytes += nbytes
            self.stage_ops += 1
            self._stage_projected_s += self._caps.projected_seconds(
                max(nbytes, 1), 1, direction, stage=True)
            self._inflight.append(tr)
            self._prune_inflight()
        return tr

    def _prune_inflight(self) -> None:
        """Drop every finished transfer (channels complete out of order,
        so a slow head must not pin completed tails in the count)."""
        alive = [t for t in self._inflight if not t.poll()]
        self._inflight.clear()
        self._inflight.extend(alive)

    def stage_h2c(self, host_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        return self._stage(host_arr, Direction.H2C, on_complete, qname)

    def stage_c2h(self, dev_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        return self._stage(dev_arr, Direction.C2H, on_complete, qname)

    # -- selector inputs -------------------------------------------------
    def occupancy(self) -> float:
        """Fraction of the path's in-flight budget currently used."""
        with self._lock:
            self._prune_inflight()
            inflight = len(self._inflight)
        return min(inflight / max(self._caps.max_inflight, 1), 1.0)

    def stats(self) -> dict:
        base = self.backend.stats() if self.backend is not None else {}
        cold_moved = base.get("bytes_stored", 0) + base.get("bytes_loaded", 0)
        cold_ops = base.get("store_ops", 0) + base.get("load_ops", 0)
        cold_proj = base.get("projected_s", 0.0)
        detail = {k: v for k, v in base.items()
                  if k not in ("path", "bytes_moved", "ops", "projected_s")}
        telemetry = {kind: self.reactor.source_telemetry(src)
                     for kind, src in (("page", self._page_source),
                                       ("stage", self._stage_source))}
        return unified_stats(
            self.name,
            bytes_moved=cold_moved + self.stage_bytes,
            ops=cold_ops + self.stage_ops,
            projected_s=cold_proj + self._stage_projected_s,
            stage_bytes=self.stage_bytes, stage_ops=self.stage_ops,
            occupancy=self.occupancy(),
            telemetry={k: v for k, v in telemetry.items()
                       if v is not None},
            **detail)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self.backend is not None:
                self.backend.close()
        finally:
            try:
                self._close_stage()
            finally:
                self.reactor.unregister_source(self._page_source)
                self.reactor.unregister_source(self._stage_source)

    def _close_stage(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class XdmaPath(_AdapterBase):
    """Static multi-channel DMA: pages in host DRAM, staging straight
    onto the ``ChannelPool`` — the paper's XDMA design point.  ``device``
    is where staged pages land (default ``"cuda"``)."""

    name = "xdma"

    def __init__(self, n_pages: int = 0, page_bytes: int = 0,
                 n_channels: int = 4, device=None,
                 chunk_bytes: int = 1 << 22,
                 mode: CompletionMode = CompletionMode.POLLED):
        self.pool = ChannelPool(n_channels, device=device,
                                chunk_bytes=chunk_bytes)
        self.mode = mode
        backend = LocalHostBackend(n_pages, page_bytes) if n_pages else None
        super().__init__(backend, PathCapabilities(
            kind="xdma", granularity_bytes=4096,
            max_inflight=n_channels * 8,        # the pool's chunk fan-out
            batch_coalescing=False,             # one descriptor setup per op
            completion_modes=_BOTH_MODES, channels=n_channels,
            model=h100_host_path()))

    def _submit_stage(self, payload, direction, on_complete, qname):
        return self.pool.submit(payload, direction, mode=self.mode,
                                on_complete=on_complete)

    def stats(self) -> dict:
        return {**super().stats(),
                "channels": {c.name: c.bytes_moved for c in
                             self.pool.channels}}

    def _close_stage(self) -> None:
        self.pool.close()
