"""``ShardedPath``: the sharded memory fabric is itself a ``MemoryPath``.

Twin of ``repro/fabric/sharded_path.py``.

The fabric distributes one page address space over N member paths —
each member a full ``MemoryPath`` (an XDMA/QDMA host pool, a verbs
far-memory node, or even a nested ``PathSelector``) — and presents the
union as a single path, so every existing consumer (``TieredStore``,
``MemoryEngine``, checkpoints, serve) works over it unchanged:

* **placement** — a ``HashRing`` (``fabric.placement``) maps each page
  to R distinct owner members; writes replicate to every alive owner,
  reads are served by the best-scored alive replica (per-member
  ``PathSelector`` scoring, so one congested or failed shard reroutes
  without repinning the fabric);
* **batched fan-out** — ``write_many_async``/``read_many_async`` split
  a batch into one per-member sub-batch each, issue them all before
  waiting, and compose the member ``PendingIO``s into one handle whose
  deps are the member completions — per-shard doorbells stay batched,
  cross-shard operations overlap, and the composite stays
  ``wait_any``/``as_completed``-composable (what serve's overlap and
  the miss pipeline need);
* **quorum reads** — ``read_quorum`` races one read per alive owner
  via ``cplane.as_completed`` and returns as soon as a majority of
  replicas agree bit-for-bit (mismatch raises — a torn replica must
  never be served silently);
* **membership epochs** — every membership change (failure, ring flip)
  bumps ``epoch`` and stamps it down into member backends'
  ``AddressMap``s and ``MemoryNode``s, so any layer can detect stale
  routing against the fabric's current view.

Failure is fail-stop at the routing plane: ``mark_failed`` removes a
member from every owner set immediately (reads fail over to replicas,
writes degrade to the surviving owners); re-replication and ring
repair are the control plane's job (``fabric.manager.FabricManager``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.access.path import (MemoryPath, PathCapabilities,
                                     TierBackendCompat, unified_stats)
from repro_torch.access.selector import PathSelector
from repro_torch.core.channels import Direction, Transfer
from repro_torch.cplane import as_completed, default_reactor, wait_all
from repro_torch.faults.integrity import IntegrityError, PageChecksums
from repro_torch.faults.retry import RETRIABLE, RetryPolicy
from repro_torch.fabric.placement import HashRing, PlacementPolicy
from repro_torch.rmem.backend import PendingIO


def _prefailed(exc: BaseException) -> PendingIO:
    """An eager handle whose join raises ``exc``: a sub-op that failed
    while it was being issued, joined like one that failed in flight."""
    def refail(timeout: float):
        raise exc
    return PendingIO(refail)


class FabricUnavailable(RuntimeError):
    """No alive replica can serve the request (all owners failed)."""


class QuorumError(RuntimeError):
    """Replica disagreement (or too few survivors) on a quorum read."""


class ShardedPath(TierBackendCompat):
    """One ``MemoryPath`` over N member paths with replicated placement."""

    name = "fabric"

    def __init__(self, members: Sequence[MemoryPath], replicas: int = 1,
                 policy: Optional[PlacementPolicy] = None, vnodes: int = 64,
                 reactor=None, retry: Optional[RetryPolicy] = None,
                 integrity: bool = False):
        members = list(members)
        if not members:
            raise ValueError("ShardedPath needs at least one member")
        if not 1 <= replicas <= len(members):
            raise ValueError(f"replicas={replicas} must be in "
                             f"[1, {len(members)}]")
        geoms = {(m.n_pages, m.page_bytes) for m in members}
        if len(geoms) != 1:
            raise ValueError(f"members disagree on page geometry: {geoms}")
        self.n_pages, self.page_bytes = geoms.pop()
        # shard-qualify member names AFTER validation (a rejected ctor
        # must not leave callers' paths renamed): the ring, the scorer
        # and the stats all key on these, and two verbs members would
        # otherwise collide
        names: List[str] = []
        for i, m in enumerate(members):
            m.name = f"{m.name}/s{i}"
            names.append(m.name)
        self.replicas = replicas
        self._members: Dict[str, MemoryPath] = dict(zip(names, members))
        self.ring: PlacementPolicy = policy if policy is not None else \
            HashRing(names, replicas=replicas, vnodes=vnodes)
        self.epoch = 0
        self._failed: set = set()
        self._written: set = set()          # pages the fabric holds
        self._lock = threading.Lock()
        self.reactor = reactor if reactor is not None else default_reactor()
        # fabric-level per-member telemetry: every member is a reactor
        # source the manager's health checks (and benches) read
        stem = self.reactor.unique_source(self.name)
        self._sources = {}
        for n in names:
            src = f"{stem}:{n}"
            self.reactor.register_source(src, mode="interrupt")
            self._sources[n] = src
        # per-member scoring: a PathSelector reused purely as the scorer
        # (measured EWMA + occupancy per member), never for placement
        self._scorer = PathSelector(members, reactor=self.reactor)
        # fault handling (§9): both off by default — the hot paths below
        # branch on ``is None`` and stay byte-identical when disabled
        self.retry = retry
        self.checksums: Optional[PageChecksums] = \
            PageChecksums() if integrity else None
        self.integrity_failures = 0         # rows that failed verify
        self.degraded_writes = 0            # writes that lost a replica
        self._under_replicated: set = set()  # pages missing a replica copy
        self.replicated_writes = 0          # extra replica copies written
        self.failovers = 0                  # reads served off-primary
        self.quorum_reads = 0
        self.rebalances = 0
        self.pages_moved = 0
        # membership-change event log (fail / ring_flip / epoch bumps,
        # plus the manager's repair/rebalance entries): consumers —
        # serve, mainly — drain it and correlate with their own clock
        # (decode step numbers).  Bounded by being drained, not capped.
        self.events: List[dict] = []
        self._closed = False

    # -- membership ------------------------------------------------------
    @property
    def member_names(self) -> List[str]:
        return list(self._members)

    def member(self, name: str) -> MemoryPath:
        return self._members[name]

    def alive_members(self) -> List[str]:
        return [n for n in self._members if n not in self._failed]

    @property
    def failed_members(self) -> List[str]:
        return sorted(self._failed)

    @property
    def written_pages(self) -> List[int]:
        with self._lock:
            return sorted(self._written)

    def source_of(self, name: str) -> str:
        """The reactor telemetry source for one member."""
        return self._sources[name]

    def record_event(self, kind: str, **fields) -> dict:
        """Append a membership/control event (``fail``, ``ring_flip``,
        ``epoch``, manager ``repair``/``rebalance``) stamped with the
        current epoch, mirrored to the trace as ``fabric.<kind>``."""
        ev = {"kind": kind, "epoch": self.epoch,
              "t": time.perf_counter(), **fields}
        with self._lock:
            self.events.append(ev)
        if obs.trace.enabled():
            obs.instant(f"fabric.{kind}",
                        **{k: v for k, v in ev.items() if k != "t"})
        return ev

    def drain_events(self) -> List[dict]:
        """Pop and return every recorded event (consumers tag them with
        their own clock — serve uses decode step numbers)."""
        with self._lock:
            evs, self.events = self.events, []
        return evs

    def _bump_epoch(self) -> None:
        self.epoch += 1
        # stamp the new membership epoch down into every member's
        # address map / memory nodes (where the member has them), so a
        # stale router is detectable at any layer
        for m in self._members.values():
            amap = getattr(getattr(m, "backend", None), "amap", None)
            if amap is not None:
                amap.set_epoch(self.epoch)
        self.record_event("epoch")

    def mark_failed(self, name: str) -> None:
        """Fail-stop ``name`` at the routing plane: it leaves every
        owner set immediately.  Re-replication is the manager's job."""
        if name not in self._members:
            raise KeyError(f"unknown member {name!r}")
        if name in self._failed:
            return
        alive_after = [n for n in self._members
                       if n not in self._failed and n != name]
        if not alive_after:
            raise FabricUnavailable("cannot fail the last alive member")
        self._failed.add(name)
        self._bump_epoch()
        self.record_event("fail", member=name,
                          alive=len(alive_after))

    def mark_recovered(self, name: str) -> None:
        """Bring a flapped member back into the routing plane: it
        rejoins every owner set its ring position grants it.  Pages
        written while it was down are stale on it until the manager's
        ``recover_node``/``scrub`` re-copies them — which is why the
        epoch bumps: stale data behind a new epoch is detectable."""
        if name not in self._members:
            raise KeyError(f"unknown member {name!r}")
        if name not in self._failed:
            return
        self._failed.discard(name)
        self._bump_epoch()
        self.record_event("recover", member=name,
                          alive=len(self.alive_members()))

    def add_member(self, path: MemoryPath) -> str:
        """Attach a new member path (explicitly addressable for the
        manager's copy phase).  It serves no pages until a new ring
        including it is committed via ``commit_ring``."""
        if (path.n_pages, path.page_bytes) != (self.n_pages,
                                               self.page_bytes):
            raise ValueError("new member disagrees on page geometry")
        path.name = f"{path.name}/s{len(self._members)}"
        self._members[path.name] = path
        src = f"{next(iter(self._sources.values())).rsplit(':', 1)[0]}" \
              f":{path.name}"
        self.reactor.register_source(src, mode="interrupt")
        self._sources[path.name] = src
        self._scorer = PathSelector(list(self._members.values()),
                                    reactor=self.reactor)
        return path.name

    def commit_ring(self, ring: PlacementPolicy) -> None:
        """Flip placement to ``ring`` (the copy-then-flip commit point)
        and bump the membership epoch."""
        unknown = [m for m in ring.members if m not in self._members]
        if unknown:
            raise KeyError(f"ring names unknown members {unknown}")
        with self._lock:
            self.ring = ring
        self.rebalances += 1
        self._bump_epoch()
        self.record_event("ring_flip", members=list(ring.members),
                          replicas=ring.replicas)

    # -- routing ---------------------------------------------------------
    def _check(self, page: int) -> None:
        if self.n_pages < 1:
            raise RuntimeError(
                f"{self.name} path is stage-only (n_pages=0); construct "
                f"its members with page geometry to use page ops")
        if page < 0 or page >= self.n_pages:
            raise IndexError(page)

    def _owners(self, page: int) -> List[str]:
        """Alive owners, primary first (failed members skipped)."""
        return [n for n in self.ring.owners(page) if n not in self._failed]

    def _write_targets(self, page: int) -> List[str]:
        owners = self._owners(page)
        if not owners:
            raise FabricUnavailable(
                f"page {page}: every owner is failed "
                f"({self.ring.owners(page)})")
        return owners

    def _pick_reader(self, page: int, nbytes: int, batch: int) -> str:
        """Best-scored alive replica for a read — the per-member
        ``PathSelector`` scoring, so a congested/failed shard reroutes
        without the fabric repinning anything."""
        owners = self._owners(page)
        if not owners:
            raise FabricUnavailable(
                f"page {page}: no alive replica "
                f"({self.ring.owners(page)} all failed)")
        if self.ring.owners(page)[0] not in owners:
            self.failovers += 1
            # instant only (no events-list entry): per-read failovers on
            # a dead primary would grow the drained log without bound
            if obs.trace.enabled():
                obs.instant("fabric.failover", page=page,
                            primary=self.ring.owners(page)[0],
                            alive=len(owners))
        if len(owners) == 1:
            return owners[0]
        ranked = self._scorer.rank([self._members[n] for n in owners],
                                   nbytes, batch, Direction.C2H)
        return ranked[0].name

    def _record(self, name: str, dt: float, nbytes: int) -> None:
        self.reactor.record(self._sources[name], dt, nbytes)

    def _watch(self, name: str, io: PendingIO, t0: float,
               nbytes: int) -> None:
        """Record ``name``'s fabric telemetry when ITS sub-op settles —
        never after the joint join, which would charge every member the
        slowest member's latency and blind the manager's median-relative
        straggler check (an eager IO settles inside the composite's
        wait, so its callback still fires per member)."""
        io.add_callback(lambda _c: self._record(
            name, time.perf_counter() - t0, nbytes))

    # -- fault-aware replica plumbing (§9) -------------------------------
    def _issue(self, start: Callable[[], PendingIO]) -> PendingIO:
        """Start one member sub-op.  A member that completes inline (host
        memory) raises an injected fault during the issue itself; with
        fault handling on, that error is parked in a pre-failed handle,
        so the join counts it as a failed first attempt and retries or
        fails over exactly as for a fault that surfaces at the join.
        With fault handling off it propagates, as every fault does."""
        try:
            return start()
        except RETRIABLE as e:
            if self.retry is None and self.checksums is None:
                raise
            return _prefailed(e)

    def _rank_owners(self, owners: List[str], nbytes: int,
                     batch: int) -> List[str]:
        if len(owners) <= 1:
            return owners
        ranked = self._scorer.rank([self._members[n] for n in owners],
                                   nbytes, batch, Direction.C2H)
        return [m.name for m in ranked]

    def _note_integrity(self, page: int, member: str) -> None:
        # no registry counter here: stats() already mirrors this field
        # as the `fabric.integrity_failures` gauge, and a same-named
        # counter would make that export a type clash
        self.integrity_failures += 1
        if obs.trace.enabled():
            obs.instant("faults.integrity", page=page, member=member,
                        layer="fabric")

    def _read_verified(self, page: int, exclude=frozenset()) -> np.ndarray:
        """One page, replica-fallback read: try alive owners best-scored
        first (``PathSelector.rank``); a transient error or checksum
        mismatch on one replica falls through to the next.  Raises only
        when every candidate replica fails."""
        owners = [n for n in self._owners(page) if n not in exclude]
        if not owners:
            raise FabricUnavailable(
                f"page {page}: no alive replica outside {sorted(exclude)}")
        last: Optional[BaseException] = None
        for i, n in enumerate(self._rank_owners(owners, self.page_bytes, 1)):
            try:
                out = self._attempt_read(n, page)
            except RETRIABLE as e:
                last = e
                if obs.trace.enabled():
                    obs.instant("fabric.replica_fallback", page=page,
                                member=n, error=type(e).__name__)
                continue
            if i > 0 or exclude:
                self.failovers += 1
            return out
        raise last if last is not None else FabricUnavailable(
            f"page {page}: all replicas failed")

    def _attempt_read(self, n: str, page: int) -> np.ndarray:
        """Read ``page`` from member ``n`` (retry-wrapped when a policy
        is set) and verify it — a mismatch is an ``IntegrityError``, so
        the retry loop re-reads (in-flight flips heal) before the caller
        falls over to another replica (at-rest corruption heals there)."""
        def go():
            t0 = time.perf_counter()
            out = self._members[n].read(page)
            self._record(n, time.perf_counter() - t0, int(out.nbytes))
            if self.checksums is not None and \
                    not self.checksums.check(page, out):
                self._note_integrity(page, n)
                raise IntegrityError(
                    f"page {page} on {n}: checksum mismatch")
            return out
        if self.retry is not None:
            return self.retry.call(go, op="fabric.read",
                                   key=f"read:{n}:{page}", source="fabric")
        return go()

    def _join_member_io(self, n: str, io: PendingIO, reissue, timeout: float,
                        op: str, idempotent: bool = True):
        """Join one member sub-op under the retry policy: the first
        attempt is the already-issued ``io`` (its overlap is kept); a
        transient failure re-issues via ``reissue`` on THIS (consumer)
        thread — never a node thread."""
        state = {"io": io}

        def join():
            cur = state.pop("io", None)
            if cur is None:
                cur = reissue()
            return cur.wait(timeout)
        if self.retry is not None:
            return self.retry.call(join, op=op, key=f"{op}:{n}",
                                   idempotent=idempotent, source="fabric")
        return join()

    def _note_degraded(self, pages: Sequence[int], member: str,
                       exc: BaseException) -> None:
        """A replica write failed but at least one owner holds each page:
        the write succeeds degraded.  The stale/missing replica is
        remembered so ``FabricManager.scrub()`` re-copies it; checksum
        verification catches any read that lands on it meanwhile."""
        # counted on the instance only — stats() mirrors it as the
        # `fabric.degraded_writes` gauge (a same-named registry counter
        # would clash with that export)
        self.degraded_writes += 1
        with self._lock:
            self._under_replicated.update(pages)
        if obs.trace.enabled():
            obs.instant("fabric.degraded_write", member=member,
                        pages=len(pages), error=type(exc).__name__)

    @property
    def under_replicated_pages(self) -> List[int]:
        with self._lock:
            return sorted(self._under_replicated)

    # -- page ops --------------------------------------------------------
    def write(self, page: int, value: np.ndarray) -> None:
        self._check(page)
        targets = self._write_targets(page)
        if self.checksums is not None:
            self.checksums.stamp(page, np.asarray(value))
        wrote = 0
        last: Optional[BaseException] = None
        for n in targets:
            try:
                t0 = time.perf_counter()
                if self.retry is not None:
                    self.retry.call(
                        lambda n=n: self._members[n].write(page, value),
                        op="fabric.write", key=f"write:{n}:{page}",
                        idempotent=True, source="fabric")
                else:
                    self._members[n].write(page, value)
                self._record(n, time.perf_counter() - t0,
                             int(np.asarray(value).nbytes))
                wrote += 1
            except RETRIABLE as e:
                if self.retry is None:
                    raise           # fault handling off: fail loudly
                last = e
                self._note_degraded([page], n, e)
        if wrote == 0:
            raise last if last is not None else FabricUnavailable(
                f"page {page}: write failed on every owner")
        with self._lock:
            self._written.add(page)
        self.replicated_writes += len(targets) - 1

    def read(self, page: int) -> np.ndarray:
        self._check(page)
        if self.retry is None and self.checksums is None:
            n = self._pick_reader(page, self.page_bytes, 1)
            t0 = time.perf_counter()
            out = self._members[n].read(page)
            self._record(n, time.perf_counter() - t0, int(out.nbytes))
            return out
        return self._read_verified(page)

    def write_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        self.write_many_async(pages, values).wait()

    def write_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        """Replicated batched writes: one batched sub-write per member
        (its doorbell coalescing intact), all issued before any join so
        cross-shard replication overlaps; the handle's deps are the
        member completions, joined with ``wait_all``."""
        pages = list(pages)
        if len(pages) != len(values):
            raise ValueError(f"{len(pages)} pages vs {len(values)} values")
        if not pages:
            return PendingIO.ready()
        per: Dict[str, Tuple[List[int], List[np.ndarray]]] = {}
        extra = 0
        for p, v in zip(pages, values):
            self._check(p)
            targets = self._write_targets(p)
            extra += len(targets) - 1
            if self.checksums is not None:
                self.checksums.stamp(p, np.asarray(v))
            for n in targets:
                ps, vs = per.setdefault(n, ([], []))
                ps.append(p)
                vs.append(v)
        t0 = time.perf_counter()
        parts = [(n, self._issue(lambda n=n, ps=ps, vs=vs:
                                 self._members[n].write_many_async(ps, vs)),
                  sum(int(np.asarray(v).nbytes) for v in vs))
                 for n, (ps, vs) in per.items()]
        for n, io, nbytes in parts:
            self._watch(n, io, t0, nbytes)
        with self._lock:
            self._written.update(pages)
        self.replicated_writes += extra
        if self.retry is None and self.checksums is None:
            def finalize(timeout: float):
                wait_all([io for _, io, _ in parts], timeout)
                return None
            ios = [io for _, io, _ in parts]
            reactive = all(getattr(io, "reactive", False) for io in ios)
            return PendingIO(finalize, deps=ios if reactive else None)

        # fault-handling join: eager on purpose — retries/degradation
        # must run on the consumer's thread, never a node thread (a
        # re-issue from a node thread can deadlock on its own queue)
        def finalize_ft(timeout: float):
            landed: Dict[int, int] = {p: 0 for p in pages}
            last: Optional[BaseException] = None
            for n, io, _ in parts:
                ps, vs = per[n]
                try:
                    self._join_member_io(
                        n, io,
                        lambda n=n, ps=ps, vs=vs:
                            self._members[n].write_many_async(ps, vs),
                        timeout, "fabric.write_many", idempotent=True)
                except RETRIABLE as e:
                    last = e
                    self._note_degraded(ps, n, e)
                    continue
                for p in ps:
                    landed[p] += 1
            orphans = [p for p, k in landed.items() if k == 0]
            if orphans:
                raise last if last is not None else FabricUnavailable(
                    f"{len(orphans)} pages landed on no owner")
            return None
        return PendingIO(finalize_ft)

    def read_many(self, pages: Sequence[int]) -> np.ndarray:
        return self.read_many_async(pages).wait()

    def read_many_async(self, pages: Sequence[int]) -> PendingIO:
        """Replica-routed batched reads: rows group into one batched
        sub-read per serving member (chosen per page by replica score),
        all in flight at once, reassembled into the caller's row order
        when the deps settle."""
        pages = list(pages)
        if self.n_pages < 1:
            self._check(0)
        if not pages:
            return PendingIO.ready(np.empty((0, self.page_bytes), np.uint8))
        groups: Dict[str, Tuple[List[int], List[int]]] = {}
        for row, p in enumerate(pages):
            self._check(p)
            n = self._pick_reader(p, self.page_bytes, len(pages))
            rows, ps = groups.setdefault(n, ([], []))
            rows.append(row)
            ps.append(p)
        t0 = time.perf_counter()
        parts = [(n, rows, self._issue(lambda n=n, ps=ps:
                                       self._members[n].read_many_async(ps)),
                  len(ps) * self.page_bytes)
                 for n, (rows, ps) in groups.items()]
        for n, _, io, nbytes in parts:
            self._watch(n, io, t0, nbytes)
        if self.retry is None and self.checksums is None:
            def finalize(timeout: float):
                out = np.empty((len(pages), self.page_bytes), np.uint8)
                for n, rows, io, nbytes in parts:
                    out[np.asarray(rows, np.int64)] = io.wait(timeout)
                return out
            ios = [io for _, _, io, _ in parts]
            reactive = all(getattr(io, "reactive", False) for io in ios)
            return PendingIO(finalize, deps=ios if reactive else None,
                             nbytes=len(pages) * self.page_bytes)

        # fault-handling join (eager — see write_many_async): a member
        # sub-read that stays transiently broken after retries fails
        # over page-by-page to ranked replicas; a row that fails verify
        # re-reads on another replica (the verbs-corruption story)
        def finalize_ft(timeout: float):
            out = np.empty((len(pages), self.page_bytes), np.uint8)
            for n, rows, io, _ in parts:
                ps = groups[n][1]
                try:
                    got = self._join_member_io(
                        n, io,
                        lambda n=n, ps=ps:
                            self._members[n].read_many_async(ps),
                        timeout, "fabric.read_many")
                except RETRIABLE:
                    for row, p in zip(rows, ps):
                        out[row] = self._read_verified(p, exclude={n})
                    continue
                out[np.asarray(rows, np.int64)] = got
                if self.checksums is not None:
                    for row, p in zip(rows, ps):
                        if not self.checksums.check(p, out[row]):
                            self._note_integrity(p, n)
                            # no exclude: an in-flight flip heals on a
                            # plain re-read of the same replica (ranked
                            # fallback still covers at-rest corruption)
                            out[row] = self._read_verified(p)
            return out
        return PendingIO(finalize_ft,
                         nbytes=len(pages) * self.page_bytes)

    def read_quorum(self, page: int, timeout: float = 30.0) -> np.ndarray:
        """Read from every alive replica at once and return as soon as a
        majority agree bit-for-bit (``cplane.as_completed`` consumes the
        replies in settle order).  Raises ``QuorumError`` when agreement
        is impossible — too few survivors or a torn replica."""
        self._check(page)
        owners = self._owners(page)
        need = len(self.ring.owners(page)) // 2 + 1
        if len(owners) < need:
            raise QuorumError(f"page {page}: {len(owners)} alive replicas "
                              f"< quorum {need}")
        self.quorum_reads += 1
        ios = []
        for n in owners:
            try:
                ios.append(self._members[n].read_many_async([page]))
            except RETRIABLE as e:
                ios.append(_prefailed(e))   # it can't vote, as below
        votes: Dict[bytes, int] = {}
        results: Dict[bytes, np.ndarray] = {}
        for c in as_completed(ios, timeout):
            try:
                rows = c.result()
            except Exception:
                continue                    # a failed replica can't vote
            val = np.asarray(rows[0])
            key = val.tobytes()
            votes[key] = votes.get(key, 0) + 1
            results[key] = val
            if votes[key] >= need:
                return results[key]
        raise QuorumError(
            f"page {page}: no {need}-replica agreement "
            f"({sorted(votes.values(), reverse=True)} votes)")

    # -- stage ops (host <-> device): route to the best-scored member ----
    def _stage_member(self, nbytes: int, direction: Direction) -> MemoryPath:
        alive = [self._members[n] for n in self.alive_members()]
        if not alive:
            raise FabricUnavailable("no alive member for staging")
        if len(alive) == 1:
            return alive[0]
        return self._scorer.select(nbytes, 1, direction, op="stage",
                                   stage=True, candidates=alive)

    def stage_h2c(self, host_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        m = self._stage_member(int(getattr(host_arr, "nbytes", 1)) or 1,
                               Direction.H2C)
        return m.stage_h2c(host_arr, on_complete=on_complete, qname=qname)

    def stage_c2h(self, dev_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        m = self._stage_member(int(getattr(dev_arr, "nbytes", 1)) or 1,
                               Direction.C2H)
        return m.stage_c2h(dev_arr, on_complete=on_complete, qname=qname)

    # -- TieredStore hooks -----------------------------------------------
    @property
    def doorbell_batch(self) -> int:
        """Finest per-member overlap granularity (0 = no batching)."""
        return max((getattr(m, "doorbell_batch", 0) or 0
                    for m in self._members.values()), default=0)

    def fetch_group_hint(self) -> int:
        """Miss-pipeline group size for a shard-oblivious consumer: one
        doorbell's worth of pages per alive member, so a group fans out
        to one batched sub-read per shard (0 = take the whole miss set
        in one vectorized batch)."""
        depth = self.doorbell_batch
        return depth * max(len(self.alive_members()), 1) if depth else 0

    # -- selector inputs / capabilities ----------------------------------
    def capabilities(self) -> PathCapabilities:
        caps = [m.capabilities() for m in self._members.values()]
        modes = tuple(dict.fromkeys(m for c in caps
                                    for m in c.completion_modes))
        return PathCapabilities(
            kind=self.name,
            granularity_bytes=min(c.granularity_bytes for c in caps),
            max_inflight=sum(c.max_inflight for c in caps),
            batch_coalescing=any(c.batch_coalescing for c in caps),
            completion_modes=modes,
            channels=sum(c.channels for c in caps),
            model=caps[0].model, stage_model=caps[0].stage_model)

    def occupancy(self) -> float:
        alive = self.alive_members()
        if not alive:
            return 1.0
        return max(self._members[n].occupancy() for n in alive)

    def stats(self) -> dict:
        members = {n: m.stats() for n, m in self._members.items()}
        telemetry = {n: self.reactor.source_telemetry(src)
                     for n, src in self._sources.items()}
        with self._lock:
            written = len(self._written)
        agg = {k: sum(m.get(k, 0) for m in members.values())
               for k in ("bytes_stored", "bytes_loaded", "store_ops",
                         "load_ops", "store_batches", "load_batches",
                         "stage_bytes", "stage_ops")}
        return obs.export_stats("fabric", unified_stats(
            self.name,
            bytes_moved=sum(m["bytes_moved"] for m in members.values()),
            ops=sum(m["ops"] for m in members.values()),
            projected_s=sum(m["projected_s"] for m in members.values()),
            tier=self.name, members=members, **agg,
            ring={"members": list(self.ring.members),
                  "replicas": self.ring.replicas,
                  "vnodes": getattr(self.ring, "vnodes", 0)},
            epoch=self.epoch, failed=self.failed_members,
            written_pages=written,
            replicated_writes=self.replicated_writes,
            failovers=self.failovers, quorum_reads=self.quorum_reads,
            rebalances=self.rebalances, pages_moved=self.pages_moved,
            integrity_failures=self.integrity_failures,
            degraded_writes=self.degraded_writes,
            under_replicated=len(self._under_replicated),
            retry=self.retry.stats() if self.retry is not None else {},
            fabric_telemetry={n: t for n, t in telemetry.items()
                              if t is not None}))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            for m in self._members.values():
                m.close()
        finally:
            for src in self._sources.values():
                self.reactor.unregister_source(src)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
