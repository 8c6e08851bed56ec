"""``FabricManager``: the fabric's control plane.

Twin of ``repro/fabric/manager.py``.

The data plane (``ShardedPath``) routes; the manager decides *when the
routing must change* and executes the change online:

* **health** — every member is a reactor telemetry source (registered
  by the fabric); the manager watches per-member completion-latency
  EWMAs and flags members running ``threshold``× slower than the fleet
  median, reusing the ``runtime.fault.StragglerMonitor`` EWMA shape for
  explicitly-fed samples.  A flagged member can be failed over exactly
  like a dead one — the paper's "route around the slow endpoint".
* **failure** — ``fail_node`` fail-stops a member at the routing plane
  (reads fail over to replicas instantly), then *repairs*: a
  ``plan_rebalance`` diff against the survivor ring names every page
  replica the failure destroyed, and the copies run through the PR-2
  batched miss pipeline (``read_many_async`` per surviving source,
  ``write_many_async`` per destination, all overlapped) before the
  survivor ring commits.
* **scale-out** — ``rebalance(add=[path])`` attaches new members,
  copies only the ~1/N of pages whose owner set changes (the
  consistent-hash guarantee), then flips the ring: copy-then-flip, so
  every read before the flip is served by the old placement and every
  read after it by a fully-populated new one.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Sequence

from repro_torch import obs
from repro_torch.access.path import MemoryPath
from repro_torch.cplane import wait_all
from repro_torch.fabric.placement import RebalancePlan, plan_rebalance
from repro_torch.fabric.sharded_path import FabricUnavailable, ShardedPath
from repro_torch.runtime.fault import StragglerMonitor


class FabricDataLoss(RuntimeError):
    """A membership change would orphan pages with no surviving replica."""


class FabricManager:
    """Health, failover and online rebalancing over a ``ShardedPath``."""

    def __init__(self, fabric: ShardedPath,
                 straggler_threshold: float = 2.5, warmup: int = 3,
                 ewma_alpha: float = 0.2, reactor=None):
        self.fabric = fabric
        self.reactor = reactor if reactor is not None else fabric.reactor
        self.straggler_threshold = straggler_threshold
        self.warmup = warmup
        # explicit-feed monitors (fault.StragglerMonitor EWMAs), one per
        # member, for callers that time their own fabric ops
        self.monitors: Dict[str, StragglerMonitor] = {
            n: StragglerMonitor(threshold=straggler_threshold,
                                alpha=ewma_alpha, warmup=warmup)
            for n in fabric.member_names}
        self.suspects: List[str] = []
        self.repairs: List[dict] = []

    # -- health ----------------------------------------------------------
    def record(self, member: str, seconds: float, step: int = 0) -> bool:
        """Feed one observed op latency for ``member``; returns True if
        it is a straggler against that member's own EWMA baseline."""
        mon = self.monitors.setdefault(
            member, StragglerMonitor(threshold=self.straggler_threshold,
                                     warmup=self.warmup))
        slow = mon.record(step, seconds)
        if slow and member not in self.suspects:
            self.suspects.append(member)
        return slow

    def check_health(self) -> List[str]:
        """Cross-member check from the reactor telemetry the fabric
        records per member: members whose completion-latency EWMA runs
        ``threshold``× above the fleet median (with enough samples to
        trust it) are flagged as stragglers."""
        srcs = {n: self.fabric.source_of(n)
                for n in self.fabric.alive_members()}
        # one-lock snapshot: a per-member stats_for loop would compare
        # EWMAs sampled at different instants, and the median-relative
        # check is exactly the kind of cross-source comparison that
        # mixing points in time corrupts
        snaps = self.reactor.stats_many(srcs.values())
        lats = {}
        for n, src in srcs.items():
            st = snaps.get(src)
            if st is not None and st.completed >= self.warmup:
                lats[n] = st.ewma_latency_s
        if len(lats) < 2:
            return []
        med = statistics.median(lats.values())
        flagged = [n for n, lat in sorted(lats.items())
                   if lat > self.straggler_threshold * max(med, 1e-12)]
        for n in flagged:
            if n not in self.suspects:
                self.suspects.append(n)
        return flagged

    # -- plan execution (copy-then-flip) ---------------------------------
    def _execute(self, plan: RebalancePlan) -> dict:
        """Run a plan's copies through the batched miss pipeline: one
        ``read_many_async`` per source member and one
        ``write_many_async`` per destination, everything in flight
        together, joined with ``wait_all`` — then the caller flips the
        ring.  Dirty/holder bytes are re-fetched from the cold tier
        itself, never from a consumer's device copy."""
        t0 = time.perf_counter()
        by_src: Dict[str, List[int]] = {}
        for mv in plan.moves:
            # first listed source is the surviving primary
            by_src.setdefault(mv.srcs[0], []).append(mv.page)
        reads = {src: (sorted(set(pages)),
                       self.fabric.member(src).read_many_async(
                           sorted(set(pages))))
                 for src, pages in by_src.items()}
        page_bytes: Dict[int, object] = {}
        for src, (pages, io) in reads.items():
            rows = io.wait()
            for i, p in enumerate(pages):
                page_bytes[p] = rows[i]
        by_dst: Dict[str, List[int]] = {}
        for mv in plan.moves:
            by_dst.setdefault(mv.dst, []).append(mv.page)
        writes = [self.fabric.member(dst).write_many_async(
                      pages, [page_bytes[p] for p in pages])
                  for dst, pages in by_dst.items()]
        wait_all(writes)
        copied = sum(len(ps) for ps in by_dst.values())
        self.fabric.pages_moved += plan.moved_pages
        stats = {**plan.stats(), "copies_executed": copied,
                 "seconds": time.perf_counter() - t0}
        self.repairs.append(stats)
        return stats

    def _plan(self, new_members: Sequence[str],
              strict: bool = True) -> RebalancePlan:
        plan = plan_rebalance(self.fabric.ring, new_members,
                              self.fabric.written_pages,
                              alive=self.fabric.alive_members())
        if strict and plan.lost:
            raise FabricDataLoss(
                f"{len(plan.lost)} pages have no surviving replica "
                f"(e.g. {list(plan.lost)[:4]}); replication factor "
                f"{self.fabric.ring.replicas} cannot cover this change")
        return plan

    # -- membership changes ----------------------------------------------
    def fail_node(self, name: str, strict: bool = True) -> dict:
        """Fail-stop ``name`` and repair: reads fail over to replicas
        the moment the member is marked, then every replica the failure
        destroyed is re-created on the survivor ring from surviving
        sources, and the survivor ring commits.  On ``FabricDataLoss``
        the member STAYS failed (it is dead either way) and no repair
        runs — the orphaned pages are named in the exception.

        Idempotent: failing an already-failed member is a no-op — the
        repair already ran (or is running) and must not start twice."""
        if name in self.fabric.failed_members:
            return {"noop": True, "failed_member": name,
                    "copies_executed": 0}
        self.fabric.mark_failed(name)
        survivors = [m for m in self.fabric.ring.members if m != name]
        plan = self._plan(survivors, strict=strict)
        with obs.span("fabric.repair", member=name,
                      moves=plan.moved_pages):
            stats = self._execute(plan)
            self.fabric.commit_ring(
                self.fabric.ring.with_members(survivors))
        stats["failed_member"] = name
        self.fabric.record_event("repair", member=name,
                                 copies=stats["copies_executed"],
                                 seconds=stats["seconds"])
        return stats

    kill = fail_node                        # the serve/bench spelling

    def recover_node(self, name: str, strict: bool = True) -> dict:
        """Bring a flapped member back: rejoin it at the routing plane,
        re-copy every replica its ring position owns (its data is stale
        — written pages moved on without it), then commit the ring that
        includes it.  No-op if the member was never failed."""
        if name not in self.fabric.failed_members:
            return {"noop": True, "recovered_member": name,
                    "copies_executed": 0}
        self.fabric.mark_recovered(name)
        new_members = list(dict.fromkeys(
            list(self.fabric.ring.members) + [name]))
        plan = self._plan(new_members, strict=strict)
        with obs.span("fabric.recover", member=name,
                      moves=plan.moved_pages):
            stats = self._execute(plan)
            self.fabric.commit_ring(
                self.fabric.ring.with_members(new_members))
        stats["recovered_member"] = name
        self.fabric.record_event("recover_commit", member=name,
                                 copies=stats["copies_executed"],
                                 seconds=stats["seconds"])
        return stats

    def scrub(self) -> dict:
        """Background integrity pass: read every written page's replica
        copies, verify them against the fabric checksum plane, and
        repair bad or missing replicas from a verified good copy —
        batched through the same miss pipeline as repair (one
        ``read_many_async`` per member for the audit, one
        ``write_many_async`` per member for the fixes).  Requires the
        fabric to be built with ``integrity=True``."""
        fabric = self.fabric
        if fabric.checksums is None:
            return {"checked": 0, "repaired": 0, "unrepairable": 0,
                    "skipped": "fabric built without integrity"}
        pages = fabric.written_pages
        owned: Dict[str, List[int]] = {n: [] for n in
                                       fabric.alive_members()}
        for p in pages:
            for n in fabric.ring.owners(p):
                if n in owned:
                    owned[n].append(p)
        # under-replicated pages get their full owner set re-checked by
        # the audit below — plus an unconditional re-copy, since a
        # missing replica verifies trivially nowhere (it was never read)
        stale = set(fabric.under_replicated_pages)
        checked = 0
        bad: Dict[str, List[int]] = {}
        with obs.span("fabric.scrub", pages=len(pages)):
            # an audit read that faults while issued is parked by
            # _issue, so it lands in the except below like any other
            audits = {n: (ps, fabric._issue(
                          lambda n=n, ps=ps:
                              fabric.member(n).read_many_async(ps)))
                      for n, ps in owned.items() if ps}
            for n, (ps, io) in audits.items():
                try:
                    rows = io.wait()
                except Exception:
                    # member unreadable right now: its pages stay under
                    # suspicion for the next scrub pass
                    stale.update(ps)
                    continue
                checked += len(ps)
                for i, p in enumerate(ps):
                    if not fabric.checksums.check(p, rows[i]) or p in stale:
                        bad.setdefault(n, []).append(p)
            repaired = 0
            unrepairable: List[int] = []
            fixes = []
            for n, ps in bad.items():
                good_ps, good_vs = [], []
                for p in ps:
                    try:
                        good_vs.append(fabric._read_verified(
                            p, exclude={n}))
                        good_ps.append(p)
                    except Exception:
                        unrepairable.append(p)
                if good_ps:
                    fixes.append(fabric.member(n).write_many_async(
                        good_ps, good_vs))
                    repaired += len(good_ps)
            wait_all(fixes)
            with fabric._lock:
                fabric._under_replicated.difference_update(
                    p for p in stale if p not in unrepairable)
        out = {"checked": checked, "repaired": repaired,
               "unrepairable": len(unrepairable)}
        fabric.record_event("scrub", **out)
        self.repairs.append({"scrub": True, **out})
        return out

    def rebalance(self, add: Sequence[MemoryPath] = (),
                  remove: Sequence[str] = (), strict: bool = True) -> dict:
        """Online membership change: attach ``add`` members (not yet
        routable), plan the diff, copy every new replica while the old
        ring keeps serving, then flip."""
        added = [self.fabric.add_member(p) for p in add]
        new_members = [m for m in self.fabric.ring.members
                       if m not in set(remove)] + added
        if not new_members:
            raise FabricUnavailable("rebalance would empty the fabric")
        plan = self._plan(new_members, strict=strict)
        with obs.span("fabric.rebalance", added=len(added),
                      removed=len(remove), moves=plan.moved_pages):
            stats = self._execute(plan)
            self.fabric.commit_ring(
                self.fabric.ring.with_members(new_members))
        stats["added"] = added
        stats["removed"] = list(remove)
        self.fabric.record_event("rebalance", added=added,
                                 removed=list(remove),
                                 copies=stats["copies_executed"],
                                 seconds=stats["seconds"])
        return stats

    def stats(self) -> dict:
        return obs.export_stats("fabric.manager", {
            "suspects": list(self.suspects),
            "repairs": list(self.repairs),
            "n_suspects": len(self.suspects),
            "n_repairs": len(self.repairs),
            "epoch": self.fabric.epoch,
            "failed": self.fabric.failed_members})
