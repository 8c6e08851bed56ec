"""Consistent-hash placement for the sharded memory fabric.

Twin of ``repro/fabric/placement.py``: the same keyed blake2b points,
so owners and rebalance plans equal the reference's exactly.

``HashRing`` is the fabric's routing function: every member contributes
``vnodes`` points on a 64-bit ring (a keyed blake2b of ``member#vnode`` —
deterministic across processes, unlike Python's salted ``hash``), and a
page's owner set is the first R distinct members clockwise of the page's
own hash.  The consistent-hashing property is what makes membership
change cheap: adding or removing one member only re-routes the pages
whose successor walk crossed that member's points — ~1/N of them —
while every other page keeps its exact owner set.

``plan_rebalance`` turns two member lists into an explicit, auditable
move list the same way ``runtime/elastic.plan_resize`` turns a worker
list into a mesh plan: pure arithmetic up front, execution elsewhere
(``fabric.manager.FabricManager`` runs the copies and flips the ring).
A ``PageMove`` names the destination and the surviving source replicas
to copy from; pages with no surviving source are reported as ``lost``
rather than silently dropped.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass
from typing import Iterable, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable


def _h64(key: str) -> int:
    """Deterministic 64-bit point on the ring (stable across processes)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@runtime_checkable
class PlacementPolicy(Protocol):
    """What the fabric needs from a placement function: a member set,
    a replication factor, an owner list per page, and the ability to
    derive the same policy over a different member set (so rebalance
    plans can diff old vs new placement)."""

    members: Tuple[str, ...]
    replicas: int

    def owners(self, page: int,
               replicas: Optional[int] = None) -> List[str]: ...

    def with_members(self, members: Sequence[str]) -> "PlacementPolicy": ...


class HashRing:
    """Consistent-hash ring with virtual nodes and replication."""

    def __init__(self, members: Sequence[str], replicas: int = 1,
                 vnodes: int = 64):
        members = list(dict.fromkeys(members))      # order-stable dedupe
        if not members:
            raise ValueError("HashRing needs at least one member")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if replicas > len(members):
            raise ValueError(f"replicas={replicas} > {len(members)} members")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.members = tuple(members)
        self.replicas = replicas
        self.vnodes = vnodes
        points = [(_h64(f"{m}#{v}"), m)
                  for m in members for v in range(vnodes)]
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    def owners(self, page: int, replicas: Optional[int] = None) -> List[str]:
        """The R distinct members owning ``page``, primary first: the
        first R unique members clockwise of the page's hash."""
        r = self.replicas if replicas is None else replicas
        r = min(max(r, 1), len(self.members))
        h = _h64(f"page:{page}")
        i = bisect.bisect_right(self._keys, h) % len(self._points)
        out: List[str] = []
        while len(out) < r:
            m = self._points[i][1]
            if m not in out:
                out.append(m)
            i = (i + 1) % len(self._points)
        return out

    def primary(self, page: int) -> str:
        return self.owners(page, 1)[0]

    def with_members(self, members: Sequence[str]) -> "HashRing":
        return HashRing(members, replicas=min(self.replicas, len(members)),
                        vnodes=self.vnodes)

    def __repr__(self) -> str:
        return (f"HashRing(members={list(self.members)}, "
                f"replicas={self.replicas}, vnodes={self.vnodes})")


@dataclass(frozen=True)
class PageMove:
    """Copy ``page`` onto ``dst`` from any of ``srcs`` (preference
    order: surviving old owners, primary first)."""

    page: int
    dst: str
    srcs: Tuple[str, ...]


@dataclass(frozen=True)
class RebalancePlan:
    """The diff between two placements over a concrete page set.

    ``moves`` create the new replicas (copy-then-flip: all copies land
    before the ring flips), ``drops`` name replicas that stop being
    owners after the flip (space the executor may reclaim), ``lost``
    are pages whose every old owner is gone — unrecoverable without an
    external copy, surfaced instead of silently re-routed.
    """

    old_members: Tuple[str, ...]
    new_members: Tuple[str, ...]
    moves: Tuple[PageMove, ...]
    drops: Tuple[Tuple[int, str], ...]
    lost: Tuple[int, ...]
    total_pages: int

    @property
    def moved_pages(self) -> int:
        return len({m.page for m in self.moves})

    @property
    def moved_fraction(self) -> float:
        return self.moved_pages / max(self.total_pages, 1)

    def stats(self) -> dict:
        return {"total_pages": self.total_pages,
                "moved_pages": self.moved_pages,
                "moved_fraction": self.moved_fraction,
                "copies": len(self.moves), "drops": len(self.drops),
                "lost": len(self.lost),
                "old_members": list(self.old_members),
                "new_members": list(self.new_members)}


def plan_rebalance(old: PlacementPolicy, new_members: Sequence[str],
                   pages: Iterable[int],
                   alive: Optional[Iterable[str]] = None) -> RebalancePlan:
    """Diff placement under ``old`` against placement over
    ``new_members`` for the given ``pages``.

    Only pages whose owner set actually changes produce moves — the
    consistent-hashing guarantee (audited by the property tests) is
    that adding/removing one of N members re-routes ~1/N of pages and
    leaves the rest untouched.  ``alive`` restricts copy sources to
    members that can still serve reads (a failed node holds bytes
    nobody can fetch).
    """
    new = old.with_members(new_members)
    alive_set = set(alive) if alive is not None else set(old.members)
    moves: List[PageMove] = []
    drops: List[Tuple[int, str]] = []
    lost: List[int] = []
    total = 0
    for p in pages:
        total += 1
        old_own = old.owners(p)
        new_own = new.owners(p)
        srcs = tuple(m for m in old_own if m in alive_set)
        for dst in new_own:
            if dst not in old_own:
                if srcs:
                    moves.append(PageMove(p, dst, srcs))
                elif p not in lost:
                    lost.append(p)
        for m in old_own:
            if m not in new_own:
                drops.append((p, m))
    return RebalancePlan(
        old_members=tuple(old.members), new_members=tuple(new.members),
        moves=tuple(moves), drops=tuple(drops), lost=tuple(lost),
        total_pages=total)
