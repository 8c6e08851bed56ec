"""Two-level tiered page store: device hot slots over a pluggable cold tier.

Twin of ``repro/rmem/store.py``.  Hot pages live in device slots, cold
pages wherever the ``TierBackend`` puts them: host DRAM
(``LocalHostBackend``) or far-memory nodes behind verbs
(``RemoteBackend``).  The host<->device staging leg flows through a
``MemoryEngine`` over the same access path, so one mechanism owns both
hops; with a remote backend a page miss is the paper's full two-hop
path: node --verbs--> host staging --H2C--> device.

The miss path is an asynchronous, batched pipeline:

* a miss set's cold loads are batched into ``load_many_async`` calls of
  the backend's group size (a verbs backend's doorbell depth; the whole
  miss set for the host tier's vectorized row gather), all issued up
  front;
* each group stages to the device as ONE H2C transfer as soon as its
  bytes land (groups consumed in settle order via ``as_completed``),
  while later groups' cold fetches are still in flight;
* ``prefetch(pages)`` starts that pipeline without blocking, and
  ``ensure`` joins the in-flight fetch instead of re-issuing it.

A slot landed as part of a staged group keeps a *lazy* reference
``(group_tensor, row)`` instead of an eager per-row split:
``ensure_packed`` hands those pairs straight to the fused installer,
while ``ensure`` materializes the row on first touch (plain indexing
where the reference ran a jitted ``_device_row``).

*Dirty tracking*: pages loaded from (or stored to) the cold tier are
clean; only ``update_page(s)`` (a device-side write, H2C into the hot
slot) and ``mark_dirty`` dirty them.  Evicting or releasing a dirty page
drains its slot to the host (C2H, counted in ``c2h_bytes``) and stores
it cold (``dirty_evictions``); a clean page moves zero bytes
(``clean_evictions``, ``writeback_bytes_skipped``).

Capacity multipliers: an optional per-page **codec** (``rmem/codec.py``)
splits every page into *logical* bytes (what callers see) and *physical*
bytes (what the cold tier stores and the H2C moves).  Spills encode on
the host; a fetch group whose pages are plain stored pages stages its
*encoded* bytes to the device and decodes there, lazily: in the install
(``ensure_packed`` + ``install_pages(codec=...)``) or on first per-slot
touch.  Checksums stamp and verify the stored representation.  A store
can also hold **shared read-only base pages** (``publish_shared`` /
``store_dedup``): pages deduplicated against a base persist as block
deltas with refcounts; rewriting a delta page copies it out
(copy-on-write), and invalidation unmaps the key before any reuse, so a
stale key never resolves to recycled bytes.  ``capacity_bytes`` makes
the physical footprint a soft budget (``free_cold_bytes``).
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
from repro_torch.rmem import codec as codecs
from repro_torch.rmem.backend import LocalHostBackend, PendingIO, TierBackend


class TieredStore:
    """Page-granular residency manager parameterized by cold-tier backend."""

    def __init__(self, n_pages: int, page_shape: Tuple[int, ...],
                 dtype="uint8", n_hot_slots: int = 8,
                 engine: Optional[MemoryEngine] = None,
                 backend: Optional[TierBackend] = None,
                 retry: Optional[RetryPolicy] = None,
                 integrity: bool = False,
                 codec=None, codec_segments=None,
                 shared_pool: Sequence[int] = (),
                 capacity_bytes: Optional[int] = None,
                 path=None, **path_kw):
        """``path`` names the cold tier: a registered path name
        (``"xdma"``) or a constructed ``MemoryPath``, which then serves
        as the backend and, unless ``engine`` is given, carries the
        staging leg too.  ``backend=`` remains for bare tier backends.
        ``path_kw`` (``device=`` among them) go to the path's factory.

        ``codec`` names a page codec (``"none"``/``"bf16"``/``"int8"``,
        or a constructed ``PageCodec``); ``codec_segments`` gives the
        page's typed extents (default: one segment of the store dtype).
        The cold tier is sized in encoded (physical) bytes.
        ``shared_pool`` reserves pages as shared read-only bases for
        ``store_dedup``; ``capacity_bytes`` sets the soft physical-byte
        budget."""
        if n_hot_slots < 1:
            raise ValueError(n_hot_slots)
        self.n_pages = n_pages
        self.page_shape = tuple(page_shape)
        self._np_dtype = np.dtype(dtype)
        self.n_hot_slots = min(n_hot_slots, n_pages)
        self.page_bytes = int(np.prod(self.page_shape)) * \
            self._np_dtype.itemsize
        if isinstance(codec, str) or codec is None:
            codec = codecs.make_codec(codec, self.page_bytes,
                                      codec_segments,
                                      dtype=self._np_dtype.name)
        elif codec.page_bytes != self.page_bytes:
            raise ValueError(f"codec pages are {codec.page_bytes}B, "
                             f"store pages are {self.page_bytes}B")
        self.codec: Optional[codecs.PageCodec] = codec
        self.phys_page_bytes = (codec.encoded_bytes if codec is not None
                                else self.page_bytes)
        self.path = None
        if path is not None:
            if backend is not None:
                raise ValueError("pass either path= or backend=, not both")
            if isinstance(path, str):
                from repro_torch.access.registry import create_path
                path = create_path(path, n_pages=n_pages,
                                   page_bytes=self.phys_page_bytes,
                                   **path_kw)
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
            LocalHostBackend(n_pages, self.phys_page_bytes)
        if self.backend.n_pages < n_pages or \
                self.backend.page_bytes < self.phys_page_bytes:
            raise ValueError("backend geometry too small for store")
        # fault handling: None/False = the hooks vanish entirely
        self.retry = retry
        self.checksums: Optional[PageChecksums] = None
        if integrity and getattr(self.backend, "checksums", None) is None:
            self.checksums = PageChecksums()
        # device (hot) slots; _slot_src[s] = (staged_group, row) for
        # slots whose page still lives unsplit inside a group H2C;
        # _slot_enc[s]: that row holds codec-ENCODED (physical) bytes
        self.slots: List[Optional[torch.Tensor]] = [None] * self.n_hot_slots
        self._slot_src: List[Optional[Tuple[torch.Tensor, int]]] = \
            [None] * self.n_hot_slots
        self._slot_enc: List[bool] = [False] * self.n_hot_slots
        self.slot_of_page: Dict[int, int] = {}
        self.page_in_slot: List[Optional[int]] = [None] * self.n_hot_slots
        self._clock = 0
        self._last_use = [0] * self.n_hot_slots
        self.h2c_bytes = 0
        self.c2h_bytes = 0              # dirty write-backs and read_page
        # miss pipeline state
        self._dirty: set = set()            # device copy newer than cold
        self._prefetch: Dict[int, Tuple[PendingIO, int]] = {}
        self.evictions = 0
        self.clean_evictions = 0
        self.writeback_bytes_skipped = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.staged_hops = 0            # resident-writeback H2C transfers
        self.staged_hops_saved = 0      # per-page hops batching removed
        # logical-vs-physical accounting
        self.capacity_bytes = capacity_bytes
        self._phys_used: Dict[int, int] = {}    # page -> stored bytes
        self._phys_total = 0
        self.spill_bytes_logical = 0
        self.spill_bytes_physical = 0
        # shared read-only bases + delta dedup (prefix sharing)
        self._repr: Dict[int, Tuple] = {}       # page -> ("delta", b, len)
        for b in shared_pool:
            if b < 0 or b >= n_pages:
                raise IndexError(b)
        self._shared_free: List[int] = list(shared_pool)
        self._shared_base: Dict = {}            # key -> base page
        self._base_key: Dict[int, object] = {}  # base page -> key
        self._base_enc: Dict[int, np.ndarray] = {}
        self._base_refs: Dict[int, int] = {}
        self._base_clock: Dict[int, int] = {}
        self._zombies: set = set()              # invalidated, refs pending
        self.shared_hits = 0
        self.shared_misses = 0
        self.shared_evictions = 0
        self.cow_copies = 0
        self.dedup_bytes_saved = 0

    # -- cold-tier typed views ------------------------------------------
    def _to_typed(self, raw: np.ndarray) -> np.ndarray:
        return raw[:self.page_bytes].view(self._np_dtype) \
                                    .reshape(self.page_shape)

    # -- fault-wrapped cold-tier ops -------------------------------------
    def _account_store(self, page: int, nbytes: int) -> None:
        self._phys_total += nbytes - self._phys_used.pop(page, 0)
        self._phys_used[page] = nbytes

    def _account_drop(self, page: int) -> None:
        self._phys_total -= self._phys_used.pop(page, 0)

    def _put_cold(self, page: int, stored: np.ndarray) -> None:
        """Store the physical representation: checksum stamp, retry and
        byte accounting.  Full-page stores are idempotent, so they retry
        under the default policy."""
        if self.checksums is not None:
            self.checksums.stamp(page, stored)
        if self.retry is not None:
            self.retry.call(lambda: self.backend.store(page, stored),
                            op="tier.store", key=f"store:{page}",
                            idempotent=True, source="tier")
        else:
            self.backend.store(page, stored)
        self._account_store(page, stored.nbytes)
        self.spill_bytes_physical += stored.nbytes

    def _store_cold(self, page: int, raw: np.ndarray) -> None:
        """Cold store of a page's logical bytes: encode, then store.  A
        page that persisted as a delta against a shared base diverges
        here: it becomes a standalone page and drops its base ref (a
        copy-on-write copy)."""
        if page in self._base_key:
            raise ValueError(f"page {page} is a shared read-only base")
        self._drop_repr(page, cow=True)
        raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
        stored = self.codec.encode(raw) if self.codec is not None else raw
        self._put_cold(page, stored)
        self.spill_bytes_logical += self.page_bytes

    def _load_stored(self, page: int) -> np.ndarray:
        """Verified, retried sync load of the stored (physical) bytes
        (recovers a bad row of a batch)."""
        def attempt():
            raw = self.backend.load(page)
            if self.checksums is not None:
                self.checksums.verify(page, raw)
            return raw
        if self.retry is not None:
            return self.retry.call(attempt, op="tier.load",
                                   key=f"load:{page}", source="tier")
        return attempt()

    def _decode_stored(self, page: int, stored: np.ndarray) -> np.ndarray:
        """Stored bytes -> logical page bytes: a delta page is rebuilt
        against its base's encoded image first, then the codec
        inflates."""
        stored = np.asarray(stored).reshape(-1).view(np.uint8)
        rep = self._repr.get(page)
        if rep is not None:
            enc = codecs.delta_apply(self._base_enc[rep[1]],
                                     stored[:rep[2]])
        else:
            enc = stored[:self.phys_page_bytes]
        if self.codec is not None:
            return self.codec.decode(enc)
        return enc[:self.page_bytes]

    def _load_cold(self, page: int) -> np.ndarray:
        return self._decode_stored(page, self._load_stored(page))

    def _load_many_async(self, group: Sequence[int]) -> PendingIO:
        """Batched cold load, retry-wrapped when a policy is set; with no
        policy the backend's handle passes through untouched."""
        group = list(group)
        return retry_io(self.retry,
                        lambda: self.backend.load_many_async(group),
                        op="tier.load_many",
                        key=f"load_many:{group[0] if group else -1}",
                        source="tier",
                        nbytes=len(group) * self.phys_page_bytes)

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
            if obs.metrics.live():
                obs.default_registry().counter(
                    "tier.integrity_failures").inc(len(bad))
            if obs.trace.enabled():
                obs.instant("faults.integrity",
                            pages=[p for _, p in bad], layer="tier")
            raw = np.array(raw, copy=True)  # gather rows may be shared
            for k, p in bad:
                got = self._load_stored(p)
                raw[k, :got.shape[-1]] = got
        return raw

    def _slot_array(self, s: int) -> Optional[torch.Tensor]:
        """The slot's device tensor, splitting a lazily-held staged group
        row on first per-slot touch (decoding it on the device if it
        landed codec-encoded)."""
        src = self._slot_src[s]
        if src is not None:
            if self._slot_enc[s]:
                dec = codecs.row_decoder(self.codec, self._np_dtype.name,
                                         self.page_shape)
                self.slots[s] = dec(src[0], src[1])
                self._slot_enc[s] = False
            else:
                self.slots[s] = src[0][src[1]]
            self._slot_src[s] = None
        return self.slots[s]

    def staged_encoded(self, page: int) -> bool:
        """True when ``page``'s resident slot holds the codec-encoded
        staged row (``ensure_packed`` callers install such pages through
        ``install_pages(codec=...)``)."""
        s = self.slot_of_page.get(page)
        return s is not None and self._slot_enc[s]

    def read_page(self, page: int) -> np.ndarray:
        """Cold-tier view of a page (host copy, typed).  If the page is
        device-resident its slot is authoritative: drain it (C2H)."""
        if page < 0 or page >= self.n_pages:
            raise IndexError(page)
        if page in self.slot_of_page:
            return self._drain(self.slot_of_page[page])
        return self._to_typed(self._load_cold(page))

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
            self._slot_enc[s] = False
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
            # overwriting a page that persisted as a shared-base delta is
            # a divergence: it copies out to a standalone page (COW)
            self._store_cold(page, arr.reshape(-1).view(np.uint8))
            self._dirty.discard(page)
        self._stage_resident([(p, a) for p, a in items
                              if p in self.slot_of_page])

    # -- dirty tracking --------------------------------------------------
    def mark_dirty(self, page: int) -> None:
        """Flag a resident page's device copy as newer than its cold
        copy, so the next eviction/release writes it back."""
        if page not in self.slot_of_page:
            raise KeyError(f"page {page} is not resident")
        self._dirty.add(page)

    def is_dirty(self, page: int) -> bool:
        return page in self._dirty

    def update_page(self, page: int, value) -> torch.Tensor:
        """Device-side page update: installs ``value`` into the resident
        page's hot slot (H2C) and marks it dirty — the cold copy is stale
        until eviction/release writes it back."""
        self.update_pages({page: value})
        return self._slot_array(self.slot_of_page[page])

    def update_pages(self, updates) -> None:
        """Batched ``update_page``: all pages (each must be resident)
        share one staged H2C transfer and are marked dirty."""
        items = []
        for page, value in updates.items():
            if page not in self.slot_of_page:
                raise KeyError(f"page {page} is not resident")
            items.append((page, np.asarray(value, self._np_dtype)
                          .reshape(self.page_shape)))
        self._stage_resident(items)
        for page, _ in items:
            self._dirty.add(page)

    def _drain(self, s: int) -> np.ndarray:
        """Slot ``s``'s page on the host: one C2H, counted."""
        host = np.asarray(self.engine.read(self._slot_array(s)).wait())
        self.c2h_bytes += self.page_bytes
        return host

    def _write_back(self, page: int, s: int) -> None:
        """Drain a dirty slot and store it cold."""
        self._store_cold(page, self._drain(s).reshape(-1).view(np.uint8))

    # -- residency -------------------------------------------------------
    def _evict(self) -> int:
        s = min(range(self.n_hot_slots), key=lambda i: self._last_use[i])
        old = self.page_in_slot[s]
        if old is not None:
            self.evictions += 1
            if obs.trace.enabled():
                obs.instant("tier.evict", page=old,
                            dirty=old in self._dirty)
            if old in self._dirty:
                self._write_back(old, s)
                self._dirty.discard(old)
            else:
                # clean page: the cold copy is already identical — skip
                # the C2H drain and the cold store, moving zero bytes
                self.clean_evictions += 1
                self.writeback_bytes_skipped += self.page_bytes
            del self.slot_of_page[old]
        self.page_in_slot[s] = None
        self.slots[s] = None
        self._slot_src[s] = None
        self._slot_enc[s] = False
        return s

    def _fetch_depth(self, n_missing: int) -> int:
        """Cold-load group size, chosen by the backend: a verbs backend
        (or a selector with a verbs member) takes its doorbell depth,
        anything else the whole miss set as one vectorized batch."""
        return max(1, getattr(self.backend, "doorbell_batch", 0)
                   or n_missing)

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
            depth = self._fetch_depth(len(miss))
            with obs.span("tier.prefetch", pages=len(miss), depth=depth):
                for i in range(0, len(miss), depth):
                    group = miss[i:i + depth]
                    io = self._load_many_async(group)
                    for k, p in enumerate(group):
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
        depth = self._fetch_depth(len(cold))
        for i in range(0, len(cold), depth):
            g = cold[i:i + depth]
            groups.append((g, self._load_many_async(g),
                           list(range(len(g)))))
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
                    self._dirty.discard(p)  # fresh from cold: clean
                sel = raw if rows == list(range(len(raw))) else \
                    raw[np.asarray(rows)]
                if any(p in self._repr for p in group_pages):
                    # delta pages rebuild on the host against their base
                    typed = np.stack([
                        self._decode_stored(p, r)
                        for p, r in zip(group_pages, sel)])
                    enc = False
                elif self.codec is not None:
                    # stage the ENCODED group: H2C moves physical bytes,
                    # the decode runs on the device (install or first
                    # per-slot touch)
                    typed = np.ascontiguousarray(
                        sel[:, :self.phys_page_bytes])
                    enc = True
                else:
                    typed = np.ascontiguousarray(sel[:, :self.page_bytes])
                    enc = False
                if not enc:
                    typed = typed.view(self._np_dtype).reshape(
                        (len(group_pages),) + self.page_shape)
                    if len(group_pages) == 1:
                        typed = typed[0]
                pending.append((slots_g, self.engine.write(typed), enc))
            for slots_g, tr, enc in pending:
                dev = tr.wait()
                if len(slots_g) == 1 and not enc:
                    self.slots[slots_g[0]] = dev
                    self._slot_src[slots_g[0]] = None
                    self._slot_enc[slots_g[0]] = False
                else:
                    # keep the staged group whole: each slot remembers
                    # its (group, row) source
                    for k, s in enumerate(slots_g):
                        self.slots[s] = None
                        self._slot_src[s] = (dev, k)
                        self._slot_enc[s] = enc
                installed.update(slots_g)
                self.h2c_bytes += len(slots_g) * (
                    self.phys_page_bytes if enc else self.page_bytes)
        except BaseException:
            # a group's fetch/stage failed: unmap every page of this call
            # whose device tensor never landed
            for p, s in assigned:
                if s not in installed:
                    self.slot_of_page.pop(p, None)
                    self.page_in_slot[s] = None
                    self.slots[s] = None
                    self._slot_src[s] = None
                    self._slot_enc[s] = False
                    self._last_use[s] = 0
            raise
        if missing and obs.trace.enabled():
            obs.complete("tier.ensure", t0, time.perf_counter() - t0,
                         args={"pages": len(pages),
                               "miss": len(missing),
                               "prefetch_hits": len(fetched)})

    def release(self, page: int, writeback: Optional[bool] = None) -> None:
        """Drop a page's residency.

        ``writeback=None`` (default) and ``True`` drain the page to the
        cold tier *only if it is dirty* — clean pages already match their
        cold copy, so they move zero bytes.  ``False`` discards the
        device copy unconditionally (dirty state included)."""
        if page not in self.slot_of_page:
            return
        s = self.slot_of_page.pop(page)
        if writeback is not False and page in self._dirty:
            self._write_back(page, s)
        self._dirty.discard(page)
        self.page_in_slot[s] = None
        self.slots[s] = None
        self._slot_src[s] = None
        self._slot_enc[s] = False
        self._last_use[s] = 0

    # -- shared read-only bases + delta dedup (prefix sharing) -----------
    def _drop_repr(self, page: int, cow: bool = False) -> None:
        rep = self._repr.pop(page, None)
        if rep is not None:
            self._unref_base(rep[1])
            if cow:
                self.cow_copies += 1

    def _unref_base(self, b: int) -> None:
        self._base_refs[b] = self._base_refs.get(b, 1) - 1
        if self._base_refs[b] <= 0 and b in self._zombies:
            self._free_base_storage(b)

    def _free_base_storage(self, b: int) -> None:
        self._base_enc.pop(b, None)
        self._base_refs.pop(b, None)
        self._base_clock.pop(b, None)
        self._zombies.discard(b)
        if self.checksums is not None:
            self.checksums.drop(b)
        self._account_drop(b)
        self._shared_free.append(b)

    def lookup_shared(self, key) -> Optional[int]:
        """The live base page for ``key`` (None if never published or
        invalidated)."""
        return self._shared_base.get(key)

    def publish_shared(self, key, value, *, encoded: bool = False
                       ) -> Optional[int]:
        """Publish ``value`` (logical page bytes, or the encoded image
        with ``encoded=True``) as the shared read-only base for ``key``.
        Returns the base page, or None when the pool is exhausted and
        every base is still referenced."""
        if key in self._shared_base:
            self.invalidate_shared(key)
        if not self._shared_free:
            # recycle the LRU unreferenced base; unmap its key FIRST, so
            # a stale key can never resolve to recycled bytes
            cand = [p for p, k in self._base_key.items()
                    if self._base_refs.get(p, 0) <= 0]
            if not cand:
                return None
            victim = min(cand, key=lambda p: self._base_clock.get(p, 0))
            self.invalidate_shared(self._base_key[victim])
            self.shared_evictions += 1
        b = self._shared_free.pop()
        if encoded:
            enc = np.ascontiguousarray(value).reshape(-1).view(np.uint8)
        elif self.codec is not None:
            enc = self.codec.encode(value)
        else:
            enc = np.array(np.ascontiguousarray(value).reshape(-1)
                           .view(np.uint8)[:self.page_bytes], copy=True)
        self._put_cold(b, enc)
        self._base_enc[b] = enc
        self._base_refs[b] = 0
        self._clock += 1
        self._base_clock[b] = self._clock
        self._base_key[b] = key
        self._shared_base[key] = b
        return b

    def invalidate_shared(self, key) -> None:
        """Unmap ``key``'s base.  Its storage frees at once when no delta
        page references it; otherwise the base lingers as an unmapped
        zombie (in-flight readers stay correct) and frees when the last
        reference drains."""
        b = self._shared_base.pop(key, None)
        if b is None:
            return
        self._base_key.pop(b, None)
        if self._base_refs.get(b, 0) <= 0:
            self._free_base_storage(b)
        else:
            self._zombies.add(b)

    def store_dedup(self, page: int, value, key) -> float:
        """Store ``page`` deduplicated against the shared base for
        ``key``: the first writer publishes the base, later writers
        persist only the block delta of their encoded bytes (refcounted;
        rebuilt bit-exactly).  Falls back to a standalone store when no
        base can be placed or the delta does not shrink.  Returns the
        physical/encoded size ratio actually stored."""
        if page < 0 or page >= self.n_pages:
            raise IndexError(page)
        arr = np.asarray(value, self._np_dtype).reshape(self.page_shape)
        raw = arr.reshape(-1).view(np.uint8)
        stale = self._prefetch.pop(page, None)
        if stale is not None:
            try:
                stale[0].wait()
            except Exception:
                pass
        enc = self.codec.encode(raw) if self.codec is not None else \
            np.array(raw, copy=True)
        b = self._shared_base.get(key)
        if b is None:
            self.shared_misses += 1
            b = self.publish_shared(key, enc, encoded=True)
        else:
            self.shared_hits += 1
            self._clock += 1
            self._base_clock[b] = self._clock
        self._drop_repr(page)
        ratio = 1.0
        delta = None if b is None else \
            codecs.delta_encode(self._base_enc[b], enc)
        if delta is not None and delta.nbytes < enc.nbytes:
            self._put_cold(page, delta)
            self._repr[page] = ("delta", b, delta.nbytes)
            self._base_refs[b] = self._base_refs.get(b, 0) + 1
            self.dedup_bytes_saved += enc.nbytes - delta.nbytes
            ratio = delta.nbytes / max(enc.nbytes, 1)
        else:
            self._put_cold(page, enc)
        self.spill_bytes_logical += self.page_bytes
        self._dirty.discard(page)
        if page in self.slot_of_page:
            self._stage_resident([(page, arr)])
        return ratio

    def discard_cold(self, page: int) -> None:
        """Forget a page's cold bytes: accounting, checksum and any delta
        linkage (the base ref drops; a zombie base with no refs left
        frees).  The backend's bytes stay until the next occupant
        overwrites them."""
        if page in self._base_key:
            raise ValueError(f"page {page} is a shared base; use "
                             f"invalidate_shared")
        self._drop_repr(page)
        if self.checksums is not None:
            self.checksums.drop(page)
        self._account_drop(page)

    def free_cold_bytes(self) -> Optional[int]:
        """Remaining physical-byte budget (None when uncapped)."""
        if self.capacity_bytes is None:
            return None
        return max(0, self.capacity_bytes - self._phys_total)

    @property
    def cold_bytes_physical(self) -> int:
        return self._phys_total

    @property
    def cold_bytes_logical(self) -> int:
        return len(self._phys_used) * self.page_bytes

    @property
    def resident_pages(self):
        return sorted(self.slot_of_page)

    @property
    def dirty_pages(self):
        return sorted(self._dirty)

    # -- accounting ------------------------------------------------------
    def stats(self) -> dict:
        cold = self.backend.stats()
        moved = cold.get("bytes_stored", 0) + cold.get("bytes_loaded", 0)
        batch = getattr(self.backend, "doorbell_batch", 1)
        # stores batch up to the doorbell depth; loads amortize by the
        # observed pages-per-batched-call ratio of the miss pipeline
        load_ops = cold.get("load_ops", 0)
        load_batches = cold.get("load_batches", 0)
        avg_load_batch = load_ops / load_batches if load_batches else 1.0
        # projections rate the physical (stored, moved) page size
        projected = (
            self.backend.projected_seconds(self.phys_page_bytes, batch)
            * cold.get("store_ops", 0)
            + self.backend.projected_seconds(self.phys_page_bytes,
                                             max(avg_load_batch, 1.0))
            * load_ops)
        phys = self.cold_bytes_physical
        logical = self.cold_bytes_logical
        return obs.export_stats("tier", {
            "h2c_bytes": self.h2c_bytes, "c2h_bytes": self.c2h_bytes,
            "page_bytes": self.page_bytes,
            "phys_page_bytes": self.phys_page_bytes,
            "codec": self.codec.name if self.codec is not None else "none",
            "cold": cold,
            "cold_bytes_moved": moved,
            "cold_projected_seconds": projected,
            "cold_bytes_logical": logical,
            "cold_bytes_physical": phys,
            "compression_ratio": logical / phys if phys else 1.0,
            "spill_bytes_logical": self.spill_bytes_logical,
            "spill_bytes_physical": self.spill_bytes_physical,
            "shared_pages": len(self._shared_base),
            "shared_hits": self.shared_hits,
            "shared_misses": self.shared_misses,
            "shared_evictions": self.shared_evictions,
            "cow_copies": self.cow_copies,
            "dedup_bytes_saved": self.dedup_bytes_saved,
            "evictions": self.evictions,
            "clean_evictions": self.clean_evictions,
            "dirty_evictions": self.evictions - self.clean_evictions,
            "writeback_bytes_skipped": self.writeback_bytes_skipped,
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
