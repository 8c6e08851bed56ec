"""FleetRouter: N ServeEngine replicas over one memory fabric.

Twin of ``repro/serving/fleet.py``.  The replicas share one set of
parameters on the device (``build`` hands every replica the same
tensors) and one memory plane; the engines never close that plane, the
router does, once.

The replicas model separate serving hosts sharing one disaggregated
memory plane — in-process they step round-robin, and the fleet clock
charges ``max`` of the replicas' per-step wall times each round (the
hosts run in parallel; the slowest gates the round), the same modeling
stance ``--kv-node-latency`` takes for fabric hops.  On the card a
step's wall time covers its device work because each decode step reads
its tokens back to the host.  Goodput is served
tokens over *fleet virtual seconds*, which is what makes replica
scaling measurable in one process.

The shared plane is one address space: ``build()`` sizes the fabric at
``replicas × (batch_slots + prefix pages)`` pages and each replica owns
the page range ``[i·slots, (i+1)·slots)`` through its own
``TieredStore`` (own hot slots, shared cold tier), with its prefix-share
base pool past every replica's range.  The router — not the engines —
owns the ``FabricManager``, the mid-run node-kill schedule, and
membership event draining, so a kill is observed once, fleet-wide.

Routing is least-outstanding-work with tenant affinity: a tenant sticks
to its last replica (KV locality: its pages are already placed near it)
unless that replica is more than ``affinity_slack_tokens`` of work
busier than the least-loaded one.

When a replica is killed its whole pipeline re-routes: ingress queue,
admission backlog, pending installs (prefetches dropped on the shared
pager) and *active slots*.  In-flight requests restart from scratch on
a surviving replica — greedy decode depends only on the request's own
cache, so the restarted request reproduces the identical token
sequence: re-routing is bit-exact by construction, and the tests hold
it to that.
"""
from __future__ import annotations

import queue
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.access.registry import create_path
from repro_torch.device import resolve_device
from repro_torch.fabric import FabricManager
from repro_torch.serving.engine import (Request, ServeEngine, page_bytes_for,
                                        page_codec_for, summarize_requests)


class FleetRouter:
    def __init__(self, engines: Sequence[ServeEngine], fabric=None,
                 manager=None, kv_kill_step: Optional[int] = None,
                 kill_replica_at: Optional[Tuple[int, str]] = None,
                 affinity_slack_tokens: int = 64, shared_path=None):
        """``shared_path`` is the plane the replicas ride (the fabric,
        or one path), which ``close`` closes once; None when each
        engine owns its own."""
        if not engines:
            raise ValueError("need at least one engine")
        names = [e.name for e in engines]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate engine names: {names}")
        self.engines: Dict[str, ServeEngine] = {e.name: e
                                                for e in engines}
        self.live: List[str] = list(names)
        self.fabric = fabric
        self.shared_path = shared_path if shared_path is not None \
            else fabric
        self.manager = manager
        self.kv_kill_step = kv_kill_step
        self.kill_replica_at = kill_replica_at
        self.affinity_slack = affinity_slack_tokens
        if kv_kill_step is not None and manager is None:
            raise ValueError("kv_kill_step needs a fabric manager "
                             "(kv_shards >= 2, kv_replicas >= 2)")
        self.clock = 0.0                # fleet virtual seconds
        self.rounds = 0
        self.routed: Dict[str, int] = {n: 0 for n in names}
        self.rerouted = 0
        self.killed_replicas: List[str] = []
        self.killed_member: Optional[str] = None
        self.kill_round: Optional[int] = None
        self.kill_repair: Optional[dict] = None
        self.fabric_events: List[dict] = []
        self._affinity: Dict[str, str] = {}      # tenant -> engine name

    # -- routing ----------------------------------------------------------
    def _pick(self, req: Request) -> str:
        loads = {n: self.engines[n].outstanding_tokens()
                 for n in self.live}
        least = min(loads, key=lambda n: (loads[n], n))
        sticky = self._affinity.get(req.tenant)
        if sticky in loads and \
                loads[sticky] <= loads[least] + self.affinity_slack:
            return sticky
        return least

    def submit(self, req: Request) -> str:
        name = self._pick(req)
        self._affinity[req.tenant] = name
        self.routed[name] += 1
        if obs.trace.enabled():
            obs.instant("serve.route", rid=req.rid, tenant=req.tenant,
                        replica=name,
                        outstanding=self.engines[name]
                        .outstanding_tokens())
        self.engines[name].submit(req)
        return name

    def _resubmit(self, req: Request) -> str:
        """Re-route a request stranded on a killed replica: reset any
        partial progress (restart-from-scratch keeps tokens bit-exact)
        but keep the original submit clocks, so its TTFT/e2e honestly
        pay for the aborted first attempt."""
        req.out_tokens = []
        req.t_first_pc = 0.0
        req.t_admit_pc = 0.0
        req.failed = None
        t_submit_pc = req.t_submit_pc
        self._affinity.pop(req.tenant, None)     # dead replica: no stick
        name = self.submit(req)
        req.t_submit_pc = t_submit_pc
        self.rerouted += 1
        return name

    # -- failure injection ------------------------------------------------
    def kill_replica(self, name: str) -> int:
        """Kill one replica and re-route its whole pipeline — ingress
        queue, admission backlog, pending installs, active slots — to
        the survivors.  Returns the number of re-routed requests."""
        if name not in self.live:
            raise ValueError(f"replica {name!r} not live "
                             f"(live: {self.live})")
        if len(self.live) == 1:
            raise ValueError("cannot kill the last live replica")
        eng = self.engines[name]
        self.live.remove(name)
        self.killed_replicas.append(name)
        stranded: List[Request] = []
        while True:
            try:
                stranded.append(eng.queue.get_nowait())
            except queue.Empty:
                break
        if eng.admission is not None:
            stranded.extend(eng.admission.drain_backlog())
        for s, (req, _tok, _leaves, _spec) in sorted(
                eng._pending_install.items()):
            if eng.pager is not None:
                # join the page's in-flight fetch before anything can
                # reuse its slot, then forget it
                eng.pager.drop_prefetch(eng._pg(s))
                try:
                    eng.pager.release(eng._pg(s), writeback=False)
                except Exception:
                    pass
            stranded.append(req)
        eng._pending_install.clear()
        for s in range(eng.B):
            req = eng.slot_req[s]
            if req is None:
                continue
            eng.slot_req[s] = None
            if eng.pager is not None:
                try:
                    eng.pager.release(eng._pg(s), writeback=False)
                except Exception:
                    pass
            stranded.append(req)
        if obs.trace.enabled():
            obs.instant("serve.replica_kill", replica=name,
                        round=self.rounds, rerouted=len(stranded))
        if obs.metrics.live():
            obs.default_registry().counter(
                "serve.replica_kills").inc()
        for req in stranded:
            self._resubmit(req)
        return len(stranded)

    def _maybe_kill(self) -> None:
        if self.kv_kill_step is not None and \
                self.killed_member is None and \
                self.rounds >= self.kv_kill_step:
            victim = self.fabric.alive_members()[-1]
            if obs.trace.enabled():
                obs.instant("serve.kill", member=victim,
                            step=self.rounds)
            self.kill_repair = self.manager.kill(victim)
            self.killed_member = victim
            self.kill_round = self.rounds
        if self.kill_replica_at is not None:
            at, name = self.kill_replica_at
            if self.rounds >= at and name in self.live:
                self.kill_replica(name)

    def _drain_fabric_events(self) -> None:
        if self.fabric is None:
            return
        for ev in self.fabric.drain_events():
            ev["round"] = self.rounds
            self.fabric_events.append(ev)

    # -- the fleet loop ---------------------------------------------------
    def step_round(self) -> int:
        """One fleet round: every live replica takes one decode step (in
        parallel on real hosts — the fleet clock charges the slowest).
        Returns total active slots across the fleet."""
        self.rounds += 1
        self._maybe_kill()
        active = 0
        dts = []
        for n in list(self.live):
            eng = self.engines[n]
            t0 = time.perf_counter()
            active += eng.step()
            dts.append(time.perf_counter() - t0)
        self.clock += max(dts) if dts else 0.0
        self._drain_fabric_events()
        return active

    def idle(self) -> bool:
        return all(self.engines[n].idle() for n in self.live)

    def undrained_count(self) -> int:
        return sum(self.engines[n].undrained_count() for n in self.live)

    def run_until_drained(self, max_steps: int = 10000,
                          deadline_s: Optional[float] = None) -> int:
        t0 = time.monotonic()
        steps = 0
        while steps < max_steps and \
                (deadline_s is None or
                 time.monotonic() - t0 < deadline_s):
            steps += 1
            if self.step_round() == 0 and self.idle():
                return 0
        left = self.undrained_count()
        if left:
            warnings.warn(
                f"fleet: {left} requests still undrained after "
                f"max_steps={max_steps} (used {steps}) and "
                f"deadline_s={deadline_s} "
                f"(elapsed {time.monotonic() - t0:.3f}s)",
                RuntimeWarning, stacklevel=2)
        return left

    def run_open_loop(self, pairs: Sequence[Tuple[float, Request]],
                      max_steps: int = 10000,
                      deadline_s: Optional[float] = None) -> int:
        """Drive the fleet from an arrival schedule: each round first
        releases every request whose arrival time is due on the fleet
        clock, then steps the fleet.  With the fleet idle and arrivals
        still pending, the clock jumps to the next arrival (an idle host
        does not burn virtual time).  ``deadline_s`` bounds *wall*
        seconds; ``max_steps`` bounds rounds.  Returns the undrained
        count (0 = clean drain)."""
        todo = sorted(pairs, key=lambda p: (p[0], p[1].rid))
        i = 0
        t0 = time.monotonic()
        steps = 0
        while steps < max_steps and \
                (deadline_s is None or
                 time.monotonic() - t0 < deadline_s):
            while i < len(todo) and todo[i][0] <= self.clock:
                self.submit(todo[i][1])
                i += 1
            if self.idle() and i < len(todo):
                self.clock = max(self.clock, todo[i][0])
                continue
            steps += 1
            if self.step_round() == 0 and self.idle() and i >= len(todo):
                return 0
        left = self.undrained_count() + (len(todo) - i)
        if left:
            warnings.warn(
                f"fleet open loop: {left} requests still undrained "
                f"({len(todo) - i} never released) after "
                f"max_steps={max_steps} (used {steps}) and "
                f"deadline_s={deadline_s} "
                f"(elapsed {time.monotonic() - t0:.3f}s)",
                RuntimeWarning, stacklevel=2)
        return left

    # -- results ----------------------------------------------------------
    def done_requests(self) -> List[Request]:
        out: List[Request] = []
        for eng in self.engines.values():
            out.extend(eng.done)
        out.sort(key=lambda r: r.rid)
        return out

    def merged_hist(self, attr: str) -> obs.LogHistogram:
        """Fleet-wide latency distribution: merge the replicas' exact
        log-bucket histograms (the merge is associative)."""
        h = obs.LogHistogram()
        for eng in self.engines.values():
            h.merge(getattr(eng, attr))
        return h

    def stats(self) -> dict:
        done = self.done_requests()
        summ = summarize_requests(done)
        per_replica = {}
        for n, eng in self.engines.items():
            per_replica[n] = {
                "live": n in self.live,
                "routed": self.routed[n],
                "served": sum(1 for r in eng.done if r.failed is None),
                "shed": eng.shed_requests,
                "outstanding_tokens": eng.outstanding_tokens(),
            }
        return {
            "replicas": len(self.engines),
            "live": list(self.live),
            "rounds": self.rounds,
            "virtual_seconds": self.clock,
            "served": len(summ["served"]),
            "tokens": summ["tokens"],
            "goodput_tok_per_vs": (summ["tokens"] / self.clock
                                   if self.clock > 0 else 0.0),
            "rejected": summ["rejected"],
            "rerouted": self.rerouted,
            "killed_replicas": list(self.killed_replicas),
            "killed_member": self.killed_member,
            "kill_round": self.kill_round,
            "per_replica": per_replica,
        }

    def close(self) -> None:
        # every replica's store joins its own prefetches (an engine over
        # the shared plane leaves the path open); the plane closes once
        for eng in self.engines.values():
            eng.close()
        if self.shared_path is not None:
            self.shared_path.close()

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, cfg, params, replicas: int, batch_slots: int = 4,
              max_len: int = 256, access_path: Optional[str] = None,
              kv_shards: int = 1, kv_replicas: int = 1,
              kv_kill_step: Optional[int] = None, kv_doorbell: int = 4,
              overlap: bool = True, overlap_grace_s: float = 0.002,
              kv_node_latency_s: float = 0.0, kv_retry=None,
              kv_integrity: bool = False, admission_factory=None,
              kill_replica_at: Optional[Tuple[int, str]] = None,
              affinity_slack_tokens: int = 64,
              fused_install: bool = True,
              kv_codec: str = "none",
              prefix_share: bool = False, prefix_pages: int = 8,
              kv_capacity_bytes: Optional[int] = None,
              device=None) -> "FleetRouter":
        """Build N replicas over one memory plane.

        ``replicas == 1`` degrades to the legacy single-engine shape:
        the engine owns its path (and the kill schedule, if any) and the
        router is a thin pass-through.  With ``replicas > 1`` and paging
        on, the plane is shared: one fabric (or raw path) sized
        ``replicas × (batch_slots + prefix pages)`` pages, partitioned by
        page range.
        ``admission_factory`` is called once per replica — each gets its
        own controller (its own virtual clock: admission is a per-host
        decision; only the memory plane is shared).  ``params`` must
        live on ``device`` (default ``"cuda"``, which raises without a
        card); every replica gets the same tensors.
        """
        dev = resolve_device(device)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if kill_replica_at is not None and replicas < 2:
            raise ValueError("kill_replica_at needs replicas >= 2: "
                             "there must be a survivor to re-route to")
        mk_adm = admission_factory or (lambda: None)
        if replicas == 1:
            eng = ServeEngine(
                cfg, params, batch_slots=batch_slots, max_len=max_len,
                access_path=access_path, kv_shards=kv_shards,
                kv_replicas=kv_replicas, kv_kill_step=kv_kill_step,
                kv_doorbell=kv_doorbell, overlap=overlap,
                overlap_grace_s=overlap_grace_s,
                kv_node_latency_s=kv_node_latency_s, kv_retry=kv_retry,
                kv_integrity=kv_integrity, admission=mk_adm(),
                fused_install=fused_install, kv_codec=kv_codec,
                prefix_share=prefix_share, prefix_pages=prefix_pages,
                kv_capacity_bytes=kv_capacity_bytes, name="replica0",
                device=dev)
            return cls([eng], kill_replica_at=None,
                       affinity_slack_tokens=affinity_slack_tokens)
        paged = access_path is not None or kv_shards > 1
        shared = manager = None
        prefix = prefix_pages if prefix_share else 0
        total = replicas * (batch_slots + prefix)
        if paged:
            if access_path is None:
                access_path = "xdma"
            page_bytes = page_bytes_for(cfg, max_len)
            # the fabric is sized in *physical* (codec-encoded) bytes —
            # the capacity the compression actually buys — and
            # carries each replica's shared-prefix base pool past every
            # replica's per-slot page range
            codec_obj = page_codec_for(cfg, max_len, kv_codec)
            phys_bytes = codec_obj.encoded_bytes if codec_obj is not None \
                else page_bytes
            if kv_shards > 1:
                shared = create_path(
                    "fabric", member=access_path, shards=kv_shards,
                    replicas=kv_replicas, n_pages=total,
                    page_bytes=phys_bytes, n_channels=2, n_nodes=1,
                    doorbell_batch=kv_doorbell,
                    node_latency_s=kv_node_latency_s, retry=kv_retry,
                    integrity=kv_integrity, device=dev)
                manager = FabricManager(shared)
            else:
                if kv_kill_step is not None:
                    raise ValueError(
                        "kv_kill_step without a sharded, replicated "
                        "fabric would lose pages: use kv_shards >= 2 "
                        "and kv_replicas >= 2")
                shared = create_path(
                    access_path, n_pages=total, page_bytes=phys_bytes,
                    n_channels=2, n_nodes=1, doorbell_batch=kv_doorbell,
                    node_latency_s=kv_node_latency_s, device=dev)
        engines = []
        for i in range(replicas):
            engines.append(ServeEngine(
                cfg, params, batch_slots=batch_slots, max_len=max_len,
                overlap=overlap, overlap_grace_s=overlap_grace_s,
                kv_retry=kv_retry, kv_integrity=kv_integrity,
                admission=mk_adm(), shared_path=shared,
                page_base=i * batch_slots,
                total_pages=total if shared is not None else None,
                fused_install=fused_install, kv_codec=kv_codec,
                prefix_share=prefix_share, prefix_pages=prefix_pages,
                prefix_base=(replicas * batch_slots + i * prefix)
                if (shared is not None and prefix) else None,
                kv_capacity_bytes=kv_capacity_bytes,
                name=f"replica{i}", device=dev))
        return cls(engines, fabric=shared if kv_shards > 1 else None,
                   manager=manager, kv_kill_step=kv_kill_step,
                   kill_replica_at=kill_replica_at,
                   affinity_slack_tokens=affinity_slack_tokens,
                   shared_path=shared)
