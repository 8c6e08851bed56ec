"""Two-level tiered page store: device hot slots over a pluggable cold tier.

Twin of ``repro/rmem/store.py`` for this slice.  Hot pages live in
device slots, cold pages wherever the ``TierBackend`` puts them (host
DRAM behind ``LocalHostBackend``).  The host<->device staging leg flows
through a ``MemoryEngine`` over the same access path, so one mechanism
owns both hops.

The miss path is an asynchronous, batched pipeline:

* a miss set's cold loads are batched into one ``load_many_async``
  call (the host tier's vectorized row gather);
* each group stages to the device as ONE H2C transfer as soon as its
  bytes land (groups consumed in settle order via ``as_completed``);
* ``prefetch(pages)`` starts that pipeline without blocking, and
  ``ensure`` joins the in-flight fetch instead of re-issuing it.

A slot landed as part of a staged group keeps a *lazy* reference
``(group_tensor, row)`` instead of an eager per-row split:
``ensure_packed`` hands those pairs straight to the fused installer,
while ``ensure`` materializes the row on first touch (plain indexing
where the reference ran a jitted ``_device_row``).

Pages are written only through ``write_page(s)``, which stores cold and
refreshes a resident copy, so a device copy is never newer than its cold
copy: eviction and release move no bytes back.

Not in this slice: page codecs and shared prefix pages (asking for
either raises), and the soft capacity budget.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import MemoryEngine
from repro_torch.cplane import Completion, as_completed
from repro_torch.faults.integrity import PageChecksums
from repro_torch.faults.retry import RetryPolicy, retry_io
from repro_torch.rmem.backend import LocalHostBackend, PendingIO, TierBackend


class TieredStore:
    """Page-granular residency manager parameterized by cold-tier backend."""

    def __init__(self, n_pages: int, page_shape: Tuple[int, ...],
                 dtype="uint8", n_hot_slots: int = 8,
                 engine: Optional[MemoryEngine] = None,
                 backend: Optional[TierBackend] = None,
                 retry: Optional[RetryPolicy] = None,
                 integrity: bool = False,
                 codec=None, shared_pool: Sequence[int] = (),
                 path=None, **path_kw):
        """``path`` names the cold tier: a registered path name
        (``"xdma"``) or a constructed ``MemoryPath``, which then serves
        as the backend and, unless ``engine`` is given, carries the
        staging leg too.  ``backend=`` remains for bare tier backends.
        ``path_kw`` (``device=`` among them) go to the path's factory."""
        if codec not in (None, "none"):
            raise NotImplementedError("page codecs wait for the codec slice")
        if len(shared_pool):
            raise NotImplementedError("shared prefix pages wait for the "
                                      "prefix-sharing slice")
        if n_hot_slots < 1:
            raise ValueError(n_hot_slots)
        self.n_pages = n_pages
        self.page_shape = tuple(page_shape)
        self._np_dtype = np.dtype(dtype)
        self.n_hot_slots = min(n_hot_slots, n_pages)
        self.page_bytes = int(np.prod(self.page_shape)) * \
            self._np_dtype.itemsize
        self.codec = None
        self.path = None
        if path is not None:
            if backend is not None:
                raise ValueError("pass either path= or backend=, not both")
            if isinstance(path, str):
                from repro_torch.access.registry import create_path
                path = create_path(path, n_pages=n_pages,
                                   page_bytes=self.page_bytes, **path_kw)
            self.path = path
            backend = path                  # MemoryPath ⊇ TierBackend
            if engine is None:
                engine = MemoryEngine(path=path)   # shared, not owned
        elif path_kw:
            raise TypeError(f"unexpected kwargs {sorted(path_kw)} "
                            f"(only valid with path=)")
        if engine is None:
            raise ValueError("a TieredStore needs path= or engine=")
        self.engine = engine
        self.backend: TierBackend = backend if backend is not None else \
            LocalHostBackend(n_pages, self.page_bytes)
        if self.backend.n_pages < n_pages or \
                self.backend.page_bytes < self.page_bytes:
            raise ValueError("backend geometry too small for store")
        # fault handling: None/False = the hooks vanish entirely
        self.retry = retry
        self.checksums: Optional[PageChecksums] = None
        if integrity and getattr(self.backend, "checksums", None) is None:
            self.checksums = PageChecksums()
        # device (hot) slots; _slot_src[s] = (staged_group, row) for
        # slots whose page still lives unsplit inside a group H2C
        self.slots: List[Optional[torch.Tensor]] = [None] * self.n_hot_slots
        self._slot_src: List[Optional[Tuple[torch.Tensor, int]]] = \
            [None] * self.n_hot_slots
        self.slot_of_page: Dict[int, int] = {}
        self.page_in_slot: List[Optional[int]] = [None] * self.n_hot_slots
        self._clock = 0
        self._last_use = [0] * self.n_hot_slots
        self.h2c_bytes = 0
        self._prefetch: Dict[int, Tuple[PendingIO, int]] = {}
        self._stored: set = set()           # pages with cold bytes
        self.evictions = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.staged_hops = 0            # resident-writeback H2C transfers
        self.staged_hops_saved = 0      # per-page hops batching removed
        self.spill_bytes = 0

    # -- fault-wrapped cold-tier ops -------------------------------------
    def _store_cold(self, page: int, raw: np.ndarray) -> None:
        """Checksum stamp + retried store of a page's bytes.  Full-page
        stores are idempotent, so they retry under the default policy."""
        if self.checksums is not None:
            self.checksums.stamp(page, raw)
        if self.retry is not None:
            self.retry.call(lambda: self.backend.store(page, raw),
                            op="tier.store", key=f"store:{page}",
                            idempotent=True, source="tier")
        else:
            self.backend.store(page, raw)
        self._stored.add(page)
        self.spill_bytes += raw.nbytes

    def _load_cold(self, page: int) -> np.ndarray:
        """Verified, retried sync load (recovers a bad row of a batch)."""
        def attempt():
            raw = self.backend.load(page)
            if self.checksums is not None:
                self.checksums.verify(page, raw)
            return raw
        if self.retry is not None:
            return self.retry.call(attempt, op="tier.load",
                                   key=f"load:{page}", source="tier")
        return attempt()

    def _load_many_async(self, group: Sequence[int]) -> PendingIO:
        """Batched cold load, retry-wrapped when a policy is set; with no
        policy the backend's handle passes through untouched."""
        group = list(group)
        return retry_io(self.retry,
                        lambda: self.backend.load_many_async(group),
                        op="tier.load_many",
                        key=f"load_many:{group[0] if group else -1}",
                        source="tier",
                        nbytes=len(group) * self.page_bytes)

    def _wait_verified(self, io: PendingIO, group_pages: Sequence[int],
                       rows: Sequence[int]):
        """Join a batched load; under integrity, verify each requested
        row and recover bad ones with a sync (retried) re-read."""
        raw = io.wait()
        if self.checksums is None:
            return raw
        bad = [(k, p) for k, p in zip(rows, group_pages)
               if not self.checksums.check(p, raw[k])]
        if bad:
            raw = np.array(raw, copy=True)  # gather rows may be shared
            for k, p in bad:
                got = self._load_cold(p)
                raw[k, :got.shape[-1]] = got
        return raw

    def _slot_array(self, s: int) -> Optional[torch.Tensor]:
        """The slot's device tensor, splitting a lazily-held staged group
        row on first per-slot touch."""
        src = self._slot_src[s]
        if src is not None:
            self.slots[s] = src[0][src[1]]
            self._slot_src[s] = None
        return self.slots[s]

    def _stage_resident(self, items: Sequence[Tuple[int, np.ndarray]]
                        ) -> None:
        """Push host values into resident pages' hot slots as ONE staged
        H2C transfer for the whole call group."""
        if not items:
            return
        self.staged_hops += 1
        self.h2c_bytes += self.page_bytes * len(items)
        dev = self.engine.write(np.stack([a for _, a in items])).wait()
        for k, (page, _) in enumerate(items):
            s = self.slot_of_page[page]
            self.slots[s] = None
            self._slot_src[s] = (dev, k)
        self.staged_hops_saved += len(items) - 1

    def write_page(self, page: int, value) -> None:
        """Update a page (cold tier + device copy if resident); any
        in-flight prefetch of the old bytes is fenced and dropped."""
        self.write_pages({page: value})

    def write_pages(self, updates) -> None:
        """Batched ``write_page``: every value lands cold, and all
        device-resident pages of the call share one staged H2C."""
        items = []
        for page, value in updates.items():
            if page < 0 or page >= self.n_pages:
                raise IndexError(page)
            items.append((page, np.asarray(value, self._np_dtype)
                          .reshape(self.page_shape)))
        for page, _ in items:
            stale = self._prefetch.pop(page, None)
            if stale is not None:
                # fence the in-flight read before overwriting its row
                try:
                    stale[0].wait()
                except Exception:
                    pass                    # discarded fetch; store decides
        for page, arr in items:
            self._store_cold(page, arr.reshape(-1).view(np.uint8))
        self._stage_resident([(p, a) for p, a in items
                              if p in self.slot_of_page])

    # -- residency -------------------------------------------------------
    def _evict(self) -> int:
        s = min(range(self.n_hot_slots), key=lambda i: self._last_use[i])
        old = self.page_in_slot[s]
        if old is not None:
            # the cold copy is current (see module doc): nothing moves
            self.evictions += 1
            if obs.trace.enabled():
                obs.instant("tier.evict", page=old)
            del self.slot_of_page[old]
        self.page_in_slot[s] = None
        self.slots[s] = None
        self._slot_src[s] = None
        return s

    def prefetch(self, pages: Sequence[int]) -> List[int]:
        """Start the miss pipeline for ``pages`` without blocking; returns
        the pages actually started."""
        miss = []
        for p in pages:
            if p < 0 or p >= self.n_pages:
                raise IndexError(p)
            if p not in self.slot_of_page and p not in self._prefetch \
                    and p not in miss:
                miss.append(p)
        if miss:
            # the host tier takes the whole miss set as one batched load
            with obs.span("tier.prefetch", pages=len(miss)):
                io = self._load_many_async(miss)
                for k, p in enumerate(miss):
                    self._prefetch[p] = (io, k)
        self.prefetch_issued += len(miss)
        return miss

    def fetch_ready(self, page: int) -> bool:
        """Non-blocking: would ``ensure([page])`` complete without waiting
        on the cold tier?"""
        if page in self.slot_of_page:
            return True
        ent = self._prefetch.get(page)
        return ent[0].poll() if ent is not None else False

    def drop_prefetch(self, page: int) -> None:
        """Abandon a page's in-flight prefetch (a shedding caller): join
        it, errors included, then forget it."""
        ent = self._prefetch.pop(page, None)
        if ent is not None:
            try:
                ent[0].wait()
            except Exception:
                pass

    def fetch_completion(self, page: int) -> Optional[Completion]:
        """The in-flight prefetch's completion handle for ``page`` (None
        if resident or never prefetched)."""
        ent = self._prefetch.get(page)
        return ent[0] if ent is not None else None

    def ensure(self, pages) -> Dict[int, torch.Tensor]:
        """Make pages resident; returns {page: device tensor}."""
        self._ensure(pages)
        out = {}
        for p in pages:
            s = self.slot_of_page[p]
            self._clock += 1
            self._last_use[s] = self._clock
            out[p] = self._slot_array(s)
        return out

    def ensure_packed(self, pages) -> Dict[int, Tuple[torch.Tensor,
                                                      Optional[int]]]:
        """``ensure`` for the fused install path: returns
        ``{page: (staged_buffer, row)}`` with group rows unsplit (row
        ``None`` means the buffer IS the page)."""
        self._ensure(pages)
        out = {}
        for p in pages:
            s = self.slot_of_page[p]
            self._clock += 1
            self._last_use[s] = self._clock
            src = self._slot_src[s]
            out[p] = src if src is not None else (self.slots[s], None)
        return out

    def _ensure(self, pages) -> None:
        t0 = time.perf_counter()
        if len(set(pages)) > self.n_hot_slots:
            raise ValueError(f"requested {len(set(pages))} pages > "
                             f"{self.n_hot_slots} hot slots")
        missing = []
        for p in pages:
            if p < 0 or p >= self.n_pages:
                raise IndexError(p)
            if p in self.slot_of_page:
                # bump requested resident pages NOW so the miss loop's
                # evictions can't pick them as LRU victims
                self._clock += 1
                self._last_use[self.slot_of_page[p]] = self._clock
            elif p not in missing:
                missing.append(p)
        fetched = [p for p in missing if p in self._prefetch]
        cold = [p for p in missing if p not in self._prefetch]
        self.prefetch_hits += len(fetched)
        groups: List[Tuple[List[int], PendingIO, List[int]]] = []
        if fetched:
            ios: Dict[int, Tuple[PendingIO, List[int], List[int]]] = {}
            for p in fetched:
                io, k = self._prefetch.pop(p)
                ent = ios.setdefault(id(io), (io, [], []))
                ent[1].append(p)
                ent[2].append(k)
            groups.extend((ps, io, ks) for io, ps, ks in ios.values())
        if cold:
            groups.append((cold, self._load_many_async(cold),
                           list(range(len(cold)))))
        # stage each group as ONE H2C transfer as soon as its cold bytes
        # land; reactive IOs are consumed in settle order
        if groups and all(getattr(io, "reactive", False)
                          for _, io, _ in groups):
            by_io = {id(g[1]): g for g in groups}
            ordered = (by_io[id(c)]
                       for c in as_completed([io for _, io, _ in groups]))
        else:
            ordered = groups
        pending = []
        assigned: List[Tuple[int, int]] = []    # (page, slot) this call
        installed: set = set()                  # slots with tensors landed
        try:
            for group_pages, io, rows in ordered:
                raw = self._wait_verified(io, group_pages, rows)
                slots_g = []
                for p in group_pages:
                    s = self._evict()
                    self._clock += 1
                    self._last_use[s] = self._clock
                    slots_g.append(s)
                    assigned.append((p, s))
                    self.page_in_slot[s] = p
                    self.slot_of_page[p] = s
                sel = raw if rows == list(range(len(raw))) else \
                    raw[np.asarray(rows)]
                sel = np.ascontiguousarray(sel[:, :self.page_bytes])
                typed = sel.view(self._np_dtype).reshape(
                    (len(group_pages),) + self.page_shape)
                if len(group_pages) == 1:
                    typed = typed[0]
                pending.append((slots_g, self.engine.write(typed)))
            for slots_g, tr in pending:
                dev = tr.wait()
                if len(slots_g) == 1:
                    self.slots[slots_g[0]] = dev
                    self._slot_src[slots_g[0]] = None
                else:
                    # keep the staged group whole: each slot remembers
                    # its (group, row) source
                    for k, s in enumerate(slots_g):
                        self.slots[s] = None
                        self._slot_src[s] = (dev, k)
                installed.update(slots_g)
                self.h2c_bytes += self.page_bytes * len(slots_g)
        except BaseException:
            # a group's fetch/stage failed: unmap every page of this call
            # whose device tensor never landed
            for p, s in assigned:
                if s not in installed:
                    self.slot_of_page.pop(p, None)
                    self.page_in_slot[s] = None
                    self.slots[s] = None
                    self._slot_src[s] = None
                    self._last_use[s] = 0
            raise
        if missing and obs.trace.enabled():
            obs.complete("tier.ensure", t0, time.perf_counter() - t0,
                         args={"pages": len(pages),
                               "miss": len(missing),
                               "prefetch_hits": len(fetched)})

    def release(self, page: int) -> None:
        """Drop a page's residency (the cold copy is current)."""
        if page not in self.slot_of_page:
            return
        s = self.slot_of_page.pop(page)
        self.page_in_slot[s] = None
        self.slots[s] = None
        self._slot_src[s] = None
        self._last_use[s] = 0

    def discard_cold(self, page: int) -> None:
        """Forget a page's cold bytes (its checksum and accounting); the
        backend's bytes stay until the next occupant overwrites them."""
        self._stored.discard(page)
        if self.checksums is not None:
            self.checksums.drop(page)

    # -- accounting ------------------------------------------------------
    def stats(self) -> dict:
        cold = self.backend.stats()
        moved = cold.get("bytes_stored", 0) + cold.get("bytes_loaded", 0)
        load_ops = cold.get("load_ops", 0)
        load_batches = cold.get("load_batches", 0)
        avg_load_batch = load_ops / load_batches if load_batches else 1.0
        projected = (
            self.backend.projected_seconds(self.page_bytes, 1)
            * cold.get("store_ops", 0)
            + self.backend.projected_seconds(self.page_bytes,
                                             max(avg_load_batch, 1.0))
            * load_ops)
        return obs.export_stats("tier", {
            "h2c_bytes": self.h2c_bytes,
            "page_bytes": self.page_bytes,
            "codec": "none",
            "cold": cold,
            "cold_bytes_moved": moved,
            "cold_projected_seconds": projected,
            "cold_pages": len(self._stored),
            "spill_bytes": self.spill_bytes,
            "evictions": self.evictions,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_hits": self.prefetch_hits,
            "staged_hops": self.staged_hops,
            "staged_hops_saved": self.staged_hops_saved})

    def close(self) -> None:
        for io, _ in list(self._prefetch.values()):
            try:
                io.wait()
            except Exception:
                pass
        self._prefetch.clear()
        self.backend.close()
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
