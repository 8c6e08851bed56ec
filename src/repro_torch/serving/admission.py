"""SLO-driven admission on a virtual-time clock.

Twin of ``repro/serving/admission.py``, plain Python: the same EWMA
constant, first-sample skip, backlog order, fractional KV budget and
shed strings, so the same scripted inputs give the same decisions.

The legacy engine refilled slots FIFO-until-full: every queued request
eventually admitted, no matter how stale its deadline already was by the
time a slot freed — under saturation that means *every* request pays the
full queue, and the p99 TTFT is the queue depth.  The controller
replaces the refill policy with an explicit decision per step:

* **priority classes** — the backlog orders by (priority desc, arrival
  seq), so a paying tenant's request passes the batch class;
* **KV-capacity awareness** — admission asks the engine for free KV
  pages (``kv_free_pages``: slots whose fabric page is neither resident
  nor mid-fetch) and never admits past them, so a page still draining
  from its previous occupant blocks re-admission instead of colliding;
* **per-tenant token quotas** — a tenant's *in-flight* token footprint
  (prompt + decode budget of admitted-but-unfinished requests) is
  capped; over-quota requests wait in the backlog (not shed) until the
  tenant's own traffic drains, so one tenant cannot starve the rest;
* **SLO shedding** — predicted TTFT = time already waited + (queued
  work ahead / batch slots) × measured service time per request; when
  that exceeds the request's deadline the request sheds NOW
  (``Request.failed="slo"``) rather than after burning a slot —
  under saturation the queue stays short and *admitted* requests keep
  their deadline, which is the whole goodput argument.

The clock is *virtual*: it advances by the engine's measured decode
cadence (``observe_step``), not wall time, so the same policy drives a
real serve loop and a fleet simulation stepping replicas round-robin.
Cadence and per-request service steps are EWMAs seeded by the first
completed step/request — until a cadence exists the controller admits
optimistically (no prediction, no shed), because a prediction with no
data is noise.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.serving.engine import Request

_EWMA = 0.3     # smoothing for cadence / service-steps estimates


class AdmissionController:
    def __init__(self, slo_ttft_s: Optional[float] = None,
                 quotas: Optional[Dict[str, int]] = None,
                 default_quota: Optional[int] = None):
        self.slo_ttft_s = slo_ttft_s
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota
        # backlog kept sorted lazily: (priority desc, enqueue seq)
        self.backlog: List[Request] = []
        self._seq = 0
        self._enq_seq: Dict[int, int] = {}       # rid -> arrival order
        # virtual-time clock + service model
        self.vt = 0.0                   # advances by measured step dt
        self.cadence_s: Optional[float] = None   # EWMA decode step dt
        self.service_steps: Optional[float] = None  # EWMA steps/request
        self._cadence_samples = 0       # the first (first-use) one skipped
        self._enq_vt: Dict[int, float] = {}      # rid -> vt at enqueue
        # per-tenant in-flight token footprint (admitted, unfinished)
        self.inflight: Dict[str, int] = {}
        self.peak_inflight: Dict[str, int] = {}
        # decision counters
        self.admitted = 0
        self.shed_slo = 0
        self.shed_quota = 0
        self.deferred = 0

    # -- model updates ----------------------------------------------------
    def observe_step(self, dt_s: float, active: int) -> None:
        """Advance virtual time by one measured decode step.  The very
        first sample is excluded from the cadence EWMA — it carries the
        first-use costs (kernel builds, library handles, allocator
        growth), which would poison predictions for dozens of steps —
        but still advances the clock (queued requests really
        did wait through it)."""
        self.vt += dt_s
        if active > 0:
            self._cadence_samples += 1
            if self._cadence_samples == 1:
                return
            self.cadence_s = dt_s if self.cadence_s is None else \
                (1 - _EWMA) * self.cadence_s + _EWMA * dt_s

    def observe_finish(self, req: Request) -> None:
        t = req.tenant
        self.inflight[t] = max(
            0, self.inflight.get(t, 0) - req.cost_tokens())
        n = len(req.out_tokens or ())
        if n > 0:
            self.service_steps = float(n) if self.service_steps is None \
                else (1 - _EWMA) * self.service_steps + _EWMA * n

    # -- queue ------------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        self._enq_seq[req.rid] = self._seq
        self._enq_vt[req.rid] = self.vt
        self._seq += 1
        self.backlog.append(req)
        self.backlog.sort(
            key=lambda r: (-r.priority, self._enq_seq[r.rid]))

    def drain_backlog(self) -> List[Request]:
        """Hand the whole backlog back (fleet re-route on replica
        kill); bookkeeping for the drained rids is dropped."""
        out, self.backlog = self.backlog, []
        for r in out:
            self._enq_seq.pop(r.rid, None)
            self._enq_vt.pop(r.rid, None)
        return out

    # -- the prediction ---------------------------------------------------
    def predicted_ttft_s(self, req: Request, position: int,
                         batch_slots: int) -> Optional[float]:
        """Predicted TTFT if admitted ``position`` places from the head:
        virtual time already waited + the wave of requests ahead of it
        (position / batch_slots, rounded up) × the measured per-request
        service time (service_steps × cadence).  ``None`` until the
        model has data — no prediction, no shed."""
        if self.cadence_s is None or self.service_steps is None:
            return None
        waited = self.vt - self._enq_vt.get(req.rid, self.vt)
        waves = math.ceil((position + 1) / max(batch_slots, 1))
        per_req = self.service_steps * self.cadence_s
        return waited + waves * per_req

    def _quota_of(self, tenant: str) -> Optional[int]:
        return self.quotas.get(tenant, self.default_quota)

    # -- the per-step decision --------------------------------------------
    def select(self, free_slots: int, kv_free: int, batch_slots: int,
               kv_cost=None
               ) -> Tuple[List[Request], List[Tuple[Request, str]]]:
        """Decide this step's admissions.  Returns ``(admits, sheds)``:
        requests to start now (at most ``min(free_slots, kv_free)``) and
        requests to fail with a reason.  Everything else stays queued.

        ``kv_cost`` (optional callable ``req -> float``) is the
        *effective* KV page cost of admitting a request: 1.0 for a
        standalone page, a fraction for requests whose spill will dedup
        against a published shared prefix.  ``kv_free`` then acts as a
        fractional page budget — the shared-prefix admission fast path
        that multiplies concurrency at fixed fabric size.  With
        ``kv_cost=None`` every request costs one page and the decision
        is exactly the legacy ``min(free_slots, kv_free)``.
        """
        admits: List[Request] = []
        sheds: List[Tuple[Request, str]] = []
        kv_budget = float(kv_free)
        kv_used = 0.0
        keep: List[Request] = []
        position = 0            # queue rank among not-yet-shed requests
        for req in self.backlog:
            quota = self._quota_of(req.tenant)
            cost = req.cost_tokens()
            if quota is not None and cost > quota:
                # can never fit: deferring would deadlock the drain loop
                sheds.append((req, f"quota: request cost {cost} tokens "
                                   f"exceeds tenant quota {quota}"))
                self.shed_quota += 1
                continue
            deadline = req.deadline_s if req.deadline_s is not None \
                else self.slo_ttft_s
            if deadline is not None:
                pred = self.predicted_ttft_s(req, position, batch_slots)
                if pred is not None and pred > deadline:
                    sheds.append((req, f"slo: predicted TTFT "
                                       f"{pred:.3f}s > deadline "
                                       f"{deadline:.3f}s"))
                    self.shed_slo += 1
                    continue
            cost_kv = 1.0 if kv_cost is None \
                else max(0.0, float(kv_cost(req)))
            if len(admits) < free_slots and \
                    kv_used + cost_kv <= kv_budget + 1e-9:
                over = quota is not None and \
                    self.inflight.get(req.tenant, 0) + cost > quota
                if over:
                    # quota full: wait for the tenant's own in-flight
                    # work to drain — backpressure, not failure
                    self.deferred += 1
                    keep.append(req)
                    position += 1
                    continue
                admits.append(req)
                kv_used += cost_kv
                self.inflight[req.tenant] = \
                    self.inflight.get(req.tenant, 0) + cost
                self.peak_inflight[req.tenant] = max(
                    self.peak_inflight.get(req.tenant, 0),
                    self.inflight[req.tenant])
                self.admitted += 1
                if obs.trace.enabled():
                    obs.instant(
                        "serve.admit", rid=req.rid, tenant=req.tenant,
                        priority=req.priority, queue_depth=position,
                        vt=round(self.vt, 6))
                continue
            keep.append(req)
            position += 1
        self.backlog = keep
        for r in admits + [s for s, _ in sheds]:
            self._enq_seq.pop(r.rid, None)
            self._enq_vt.pop(r.rid, None)
        return admits, sheds

    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed_slo": self.shed_slo,
            "shed_quota": self.shed_quota,
            "deferred": self.deferred,
            "backlog": len(self.backlog),
            "vt_s": round(self.vt, 6),
            "cadence_s": self.cadence_s,
            "service_steps": self.service_steps,
            "peak_inflight_tokens": dict(self.peak_inflight),
        }
