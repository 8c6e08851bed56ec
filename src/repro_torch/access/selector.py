"""Model-driven path selection with a recorded decision trace.

Twin of ``repro/access/selector.py``; the members' models are the
port's (``h100_host_path`` for the DMA legs, ``far_memory_path`` for
verbs), so the argmin can differ from the reference's at the same sizes.

``PathSelector`` is the policy object the paper's guidance turns into
code: given the member paths' ``PathCapabilities`` it scores every
candidate with the analytical models (``core.analytical``) — per-op setup
amortized over the batch depth iff the path coalesces, link bandwidth,
direction asymmetry — and routes each request to the argmin.  Every
selection appends a ``PathDecision`` (sizes, per-path scores, raw model
projections, the choice) to a bounded trace, so benches and tests can
audit that the policy matches the model.

Contention handling is *measured*: each member path
reports its completions into a reactor source, and the selector adds a
per-path queueing delay of ``inflight × EWMA latency`` on top of the
model projection — the calibration loop the DPU-optimization literature
shows cross-path routing needs.  With idle queues the measured term is
zero and decisions coincide exactly with the analytical argmin (the
property the bench sweep audits); under load the observed EWMA — not a
static inflation guess — steers requests away from the backed-up path,
and the decision records ``measured=True`` with the observed values.
Paths without telemetry (or without enough samples yet) fall back to
the static occupancy inflation.

The selector itself implements ``MemoryPath``, so anything that takes a
path takes a selector: page *writes* are placed per-request by the model
and remembered (``placement``), page *reads* follow the placement — bytes
come back from wherever the model put them, which is what keeps ``auto``
serving bit-exact with every pinned path.  Stage ops select per transfer
against the members' stage models.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.access.path import (MemoryPath, PathCapabilities,
                                     TierBackendCompat, unified_stats)
from repro_torch.core.analytical import PathModel
from repro_torch.core.channels import Direction, Transfer
from repro_torch.cplane import default_reactor
from repro_torch.rmem.backend import PendingIO


@dataclass(frozen=True)
class PathDecision:
    """One routing decision: what was asked, how each path scored, who won.

    ``scores`` are what the policy minimizes; ``projected`` are the raw
    analytical-model seconds (the paper's guidance with all queues idle)
    — retained on every decision as the prior and the audit.  When every
    path is idle the two argmins coincide — the property the bench sweep
    audits.  ``measured`` is True when a reactor-observed queueing delay
    (in-flight × EWMA latency) entered the scores; ``observed`` then maps
    path name -> that measured delay in seconds.
    """

    op: str
    nbytes: int
    batch: int
    direction: str
    scores: Dict[str, float]
    projected: Dict[str, float]
    occupancy: Dict[str, float]
    chosen: str
    measured: bool = False
    observed: Dict[str, float] = field(default_factory=dict)

    @property
    def model_argmin(self) -> str:
        return min(self.projected, key=self.projected.get)


class PathSelector(TierBackendCompat):
    """Routes every request to the model-optimal ``MemoryPath``."""

    name = "auto"

    def __init__(self, paths: Sequence[MemoryPath],
                 occupancy_penalty: float = 2.0, trace_limit: int = 4096,
                 reactor=None, min_measured_samples: int = 3):
        paths = list(paths)
        if not paths:
            raise ValueError("PathSelector needs at least one path")
        names = [p.name for p in paths]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate path names: {names}")
        self.paths = paths
        self.occupancy_penalty = occupancy_penalty
        self.reactor = reactor if reactor is not None else default_reactor()
        # EWMAs are noise until a few completions have landed; below this
        # the path scores on the model prior + static occupancy fallback
        self.min_measured_samples = min_measured_samples
        self._decisions: deque = deque(maxlen=max(trace_limit, 1))
        self._placement: Dict[int, MemoryPath] = {}
        self._lock = threading.Lock()
        # page geometry: every page-capable member must agree, so any
        # placement the model picks can hold any page
        paged = [p for p in paths if p.n_pages]
        geoms = {(p.n_pages, p.page_bytes) for p in paged}
        if len(geoms) > 1:
            raise ValueError(f"members disagree on page geometry: {geoms}")
        self.n_pages, self.page_bytes = (geoms.pop() if geoms else (0, 0))
        self._paged = paged
        # TieredStore uses this as its miss-pipeline group size: the
        # finest overlap granularity any member offers
        self.doorbell_batch = max(
            (getattr(p, "doorbell_batch", 0) for p in paths), default=0)

    # -- policy ----------------------------------------------------------
    def _snapshot_telemetry(self, cands: Sequence[MemoryPath],
                            stage: bool) -> Dict[str, "object"]:
        """One consistent reactor snapshot covering every candidate's
        telemetry source (single lock acquisition — comparing sources
        snapshotted at different instants would skew the ranking)."""
        srcs = []
        for p in cands:
            src_fn = getattr(p, "telemetry_source", None)
            if src_fn is not None:
                srcs.append(src_fn(stage=stage))
        return self.reactor.stats_many(srcs) if srcs else {}

    def _measured_delay(self, path: MemoryPath, stage: bool,
                        telemetry: Optional[Dict] = None
                        ) -> Optional[float]:
        """Reactor-observed queueing delay for ``path``: in-flight ops ×
        EWMA completion latency (Little's-law expected wait for the
        path's queue to drain).  ``None`` when the path exposes no
        telemetry source or hasn't completed enough ops to trust the
        EWMA; ``0.0`` when it is measurably idle.  ``telemetry`` is a
        pre-fetched ``stats_many`` snapshot (so one select compares all
        candidates at the same instant)."""
        src_fn = getattr(path, "telemetry_source", None)
        if src_fn is None:
            return None
        src = src_fn(stage=stage)
        st = telemetry.get(src) if telemetry is not None \
            else self.reactor.stats_for(src)
        if st is None or st.completed < self.min_measured_samples:
            return None
        return st.inflight * st.ewma_latency_s

    def _score_path(self, path: MemoryPath, nbytes: int, batch: int,
                    direction: Direction, stage: bool,
                    telemetry: Optional[Dict] = None):
        """The one scoring formula: ``(score, projected, occupancy,
        measured_delay)``.  Measured paths score model prior + observed
        queueing delay; unmeasured ones fall back to the static
        occupancy inflation.  ``select`` and ``score`` both route
        through here so the audited trace can never diverge from the
        actual policy."""
        proj = path.capabilities().projected_seconds(
            nbytes, batch, direction, stage) * max(batch, 1)
        occ = path.occupancy()
        delay = self._measured_delay(path, stage, telemetry)
        if delay is None:
            return (proj * (1.0 + self.occupancy_penalty * occ),
                    proj, occ, None)
        return proj + self.occupancy_penalty * delay, proj, occ, delay

    def score(self, path: MemoryPath, nbytes: int, batch: int = 1,
              direction: Direction = Direction.C2H,
              stage: bool = False) -> float:
        """Projected seconds plus the path's measured queueing delay
        (static occupancy inflation when unmeasured)."""
        return self._score_path(path, nbytes, batch, direction, stage)[0]

    def rank(self, candidates: Sequence[MemoryPath], nbytes: int,
             batch: int = 1, direction: Direction = Direction.C2H,
             stage: bool = False) -> List[MemoryPath]:
        """Candidates ordered best-first by the same scoring formula
        ``select`` minimizes — the per-member hook the sharded fabric
        uses to pick a read replica (a congested shard sinks in the
        ranking without any placement changing), with no decision
        recorded since nothing is being placed."""
        cands = list(candidates)
        tel = self._snapshot_telemetry(cands, stage)
        return sorted(cands, key=lambda p: self._score_path(
            p, nbytes, batch, direction, stage, tel)[0])

    def select(self, nbytes: int, batch: int = 1,
               direction: Direction = Direction.C2H, op: str = "write",
               stage: bool = False,
               candidates: Optional[Sequence[MemoryPath]] = None
               ) -> MemoryPath:
        cands = list(candidates) if candidates is not None else (
            self.paths if stage else (self._paged or self.paths))
        tel = self._snapshot_telemetry(cands, stage)
        scores, projected, occ, observed = {}, {}, {}, {}
        for p in cands:
            (scores[p.name], projected[p.name], occ[p.name],
             delay) = self._score_path(p, nbytes, batch, direction,
                                       stage, tel)
            if delay:
                observed[p.name] = delay
        chosen = min(cands, key=lambda p: scores[p.name])
        with self._lock:
            self._decisions.append(PathDecision(
                op=op, nbytes=int(nbytes), batch=int(batch),
                direction=direction.value, scores=scores,
                projected=projected, occupancy=occ, chosen=chosen.name,
                measured=bool(observed), observed=observed))
        if obs.trace.enabled():
            obs.instant("path.decision", op=op, nbytes=int(nbytes),
                        batch=int(batch), direction=direction.value,
                        chosen=chosen.name, measured=bool(observed))
        return chosen

    @property
    def decisions(self) -> List[PathDecision]:
        with self._lock:
            return list(self._decisions)

    def capabilities(self) -> PathCapabilities:
        """Aggregate descriptor: the envelope of the members' abilities
        (model = the first member's; per-request costs always come from
        the member actually selected)."""
        caps = [p.capabilities() for p in self.paths]
        modes = tuple(dict.fromkeys(m for c in caps
                                    for m in c.completion_modes))
        return PathCapabilities(
            kind="auto",
            granularity_bytes=min(c.granularity_bytes for c in caps),
            max_inflight=sum(c.max_inflight for c in caps),
            batch_coalescing=any(c.batch_coalescing for c in caps),
            completion_modes=modes,
            channels=max(c.channels for c in caps),
            model=caps[0].model, stage_model=caps[0].stage_model)

    # model hooks: report the best (model-optimal) member, which is the
    # one the policy would route to
    def path_model(self) -> PathModel:
        if not self._paged:
            return self.capabilities().model
        best = min(self._paged, key=lambda p: p.capabilities()
                   .projected_seconds(max(self.page_bytes, 1)))
        return best.capabilities().model

    def projected_seconds(self, nbytes: int, batch: int = 1,
                          direction: Direction = Direction.C2H) -> float:
        return min(p.capabilities().projected_seconds(nbytes, batch,
                                                      direction)
                   for p in (self._paged or self.paths))

    # -- page ops: write places, read follows placement ------------------
    def _require_paged(self) -> List[MemoryPath]:
        if not self._paged:
            raise RuntimeError("selector has no page-capable member paths")
        return self._paged

    def _place(self, page: int, nbytes: int, batch: int,
               op: str) -> MemoryPath:
        path = self.select(nbytes, batch, Direction.H2C, op=op,
                           candidates=self._require_paged())
        with self._lock:
            self._placement[page] = path
        return path

    def _owner(self, page: int) -> MemoryPath:
        with self._lock:
            owner = self._placement.get(page)
        return owner if owner is not None else self._require_paged()[0]

    def write(self, page: int, value: np.ndarray) -> None:
        nbytes = int(getattr(np.asarray(value), "nbytes", 0)) or \
            self.page_bytes
        self._place(page, nbytes, 1, "write").write(page, value)

    def read(self, page: int) -> np.ndarray:
        return self._owner(page).read(page)

    def write_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        self.write_many_async(pages, values).wait()

    def write_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        pages = list(pages)
        if not pages:
            return PendingIO.ready()
        nbytes = int(np.asarray(values[0]).nbytes) or self.page_bytes
        path = self.select(nbytes, len(pages), Direction.H2C,
                           op="write_many",
                           candidates=self._require_paged())
        with self._lock:
            for p in pages:
                self._placement[p] = path
        return path.write_many_async(pages, values)

    def read_many(self, pages: Sequence[int]) -> np.ndarray:
        return self.read_many_async(pages).wait()

    def read_many_async(self, pages: Sequence[int]) -> PendingIO:
        """Placement-routed batched read: one member batch per owning
        path, reassembled into the caller's row order on ``wait()``."""
        pages = list(pages)
        self._require_paged()
        if not pages:
            return PendingIO.ready(
                np.empty((0, self.page_bytes), np.uint8))
        groups: Dict[int, list] = {}       # id(path) -> [path, rows, pages]
        for row, page in enumerate(pages):
            owner = self._owner(page)
            ent = groups.setdefault(id(owner), [owner, [], []])
            ent[1].append(row)
            ent[2].append(page)
        parts = [(rows, path.read_many_async(grp_pages))
                 for path, rows, grp_pages in groups.values()]

        def finalize(timeout: float):
            out = np.empty((len(pages), self.page_bytes), np.uint8)
            for rows, io in parts:
                out[np.asarray(rows, np.int64)] = io.wait(timeout)
            return out
        # deps: the member IOs themselves, so the composite stays
        # poll()/wait_any-composable — unless a member is a legacy eager
        # handle that only resolves inside wait(), in which case the
        # composite must stay eager too or it would never settle
        ios = [io for _, io in parts]
        reactive = all(getattr(io, "reactive", False) for io in ios)
        return PendingIO(finalize, deps=ios if reactive else None)

    # -- stage ops: select per transfer ----------------------------------
    def stage_h2c(self, host_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        path = self.select(int(getattr(host_arr, "nbytes", 1)) or 1, 1,
                           Direction.H2C, op="stage_h2c", stage=True)
        return path.stage_h2c(host_arr, on_complete=on_complete,
                              qname=qname)

    def stage_c2h(self, dev_arr, on_complete=None,
                  qname: str = "default") -> Transfer:
        path = self.select(int(getattr(dev_arr, "nbytes", 1)) or 1, 1,
                           Direction.C2H, op="stage_c2h", stage=True)
        return path.stage_c2h(dev_arr, on_complete=on_complete,
                              qname=qname)

    def occupancy(self) -> float:
        return max(p.occupancy() for p in self.paths)

    def stats(self) -> dict:
        members = {p.name: p.stats() for p in self.paths}
        with self._lock:
            placement: Dict[str, int] = {}
            for path in self._placement.values():
                placement[path.name] = placement.get(path.name, 0) + 1
            n_decisions = len(self._decisions)
        agg = {k: sum(m.get(k, 0) for m in members.values())
               for k in ("bytes_stored", "bytes_loaded", "store_ops",
                         "load_ops", "store_batches", "load_batches",
                         "stage_bytes", "stage_ops")}
        return unified_stats(
            self.name,
            bytes_moved=sum(m["bytes_moved"] for m in members.values()),
            ops=sum(m["ops"] for m in members.values()),
            projected_s=sum(m["projected_s"] for m in members.values()),
            tier=self.name, members=members, placement=placement,
            decisions=n_decisions, **agg)

    def close(self) -> None:
        for p in self.paths:
            p.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
