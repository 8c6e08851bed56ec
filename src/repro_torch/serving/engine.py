"""Batched serving engine: continuous slot-based batching with KV paging.

Twin of ``repro/serving/engine.py`` for one engine over one access path:
``access_path`` names it (``xdma``, ``qdma``, ``verbs`` or ``auto``, the
model-driven selector over all three; ``kv_backend`` is the deprecated
spelling, ``local`` for xdma and ``remote`` for verbs), and
``kv_node_latency_s`` is the modeled far-memory round trip each verbs
doorbell pays.
Requests enter a queue; a fixed-slot batch decodes in lockstep (one
decode step for the whole batch), and freed slots are refilled from the
queue each step.  With KV paging each admitted slot's prefilled cache is
packed into one byte page, spilled to the cold tier, fetched back H2C
and installed from the device-resident page, so the cache crosses the
paper's memory path before serving.  Output is bit-exact either way.

Admission is prefetch-pipelined and decode-overlapped: an admitted slot
whose page is still in flight parks in a pending-install set, the batch
keeps decoding, and each step installs the slots whose fetch settled
(``overlap=False`` installs every pending slot at once, joining inline).

``fused_install`` routes the spill through ``pack_page`` (one kernel,
one D2H) and the install through ``install_pages`` (one kernel per
settled group, straight from the staged ``(buffer, row)`` pairs); off,
the spill reads each leaf back and each slot installs leaf by leaf in
plain PyTorch.  The non-paging install is plain PyTorch either way, as
in the reference.

Capacity multipliers, both off by default: ``kv_codec`` compresses each
page at the tier boundary (``page_codec_for``: the layout's leaves are
the codec's typed segments; encoded fetch groups install through
``install_pages(codec=...)``), and ``prefix_share`` dedups the spill of
a request whose first ``Request.prefix_len`` prompt tokens are shared
against one read-only base page per prefix.  Tokens are unchanged by
sharing, and by ``bf16`` on a bf16 cache; ``kv_capacity_bytes`` sets the
store's soft physical-byte budget, which ``kv_free_pages`` reports.

The sharded memory plane: ``kv_shards > 1`` builds a ``ShardedPath``
of that many ``access_path`` members (two channels each) with
``kv_replicas`` copies of every page, and ``kv_kill_step`` fails its
last alive member at that decode step: reads fail over to replicas and
``FabricManager.kill`` re-replicates onto the survivors inside that
step, so tokens stay bit-exact.  ``kv_nodes`` is the deprecated
spelling of ``kv_shards``.  Chaos mode: ``kv_retry`` (a ``RetryPolicy``)
and ``kv_integrity`` (per-page checksums) live in the fabric when
sharded and in the tier store otherwise, never both; a request whose
paging op stays failed after retries and failover is shed
(``Request.failed`` carries the reason) while the batch decodes on.

Not ported yet (ROADMAP A.4): the admission controller (which reads
``kv_free_pages`` and ``kv_page_cost``) and the fleet's shared plane
(``shared_path``, ``page_base``, ``total_pages``).
"""
from __future__ import annotations

import dataclasses
import queue
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import cplane, obs
from repro_torch.access.registry import create_path
from repro_torch.device import resolve_device
from repro_torch.fabric import FabricManager
from repro_torch.faults.retry import RETRIABLE, RetryPolicy
from repro_torch.interop import tree_flatten, tree_unflatten
from repro_torch.kernels import page_install as pi
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.rmem import codec as codecs
from repro_torch.rmem.store import TieredStore

# the deprecated --kv-backend spellings
_KV_BACKEND_ALIAS = {"local": "xdma", "remote": "verbs"}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int = 16
    out_tokens: Optional[List[int]] = None
    failed: Optional[str] = None       # rejection reason (engine kept going)
    # the submitting tenant, which keys the per-tenant latency metrics;
    # one engine serves "default" (the fleet frontend comes with A.4)
    tenant: str = "default"
    # shared-prefix length: the first prefix_len prompt tokens are a
    # cross-request prefix; a paging engine with prefix_share=True dedups
    # the slot's spilled page against the base keyed by those tokens
    prefix_len: int = 0
    # monotonic lifecycle clocks (perf_counter): submit -> admit is queue
    # wait, submit -> first token is TTFT, first -> done over the
    # remaining tokens is TPOT, submit -> done is e2e latency
    t_submit_pc: float = 0.0
    t_admit_pc: float = 0.0
    t_first_pc: float = 0.0
    t_done_pc: float = 0.0


def failure_kind(reason: str) -> str:
    """Classify a ``Request.failed`` reason into the short kinds the
    result dict's ``rejected.reasons`` section counts by."""
    if "prompt length" in reason:
        return "overlong"
    if "store failed" in reason:
        return "kv_store"
    if "fetch failed" in reason:
        return "kv_fetch"
    return "other"


def summarize_requests(done: List[Request]) -> dict:
    """Split finished requests into served vs rejected: latency and token
    totals cover served requests only; rejected ones are counted by
    reason."""
    served = [r for r in done if r.failed is None]
    failed = [r for r in done if r.failed is not None]
    reasons: Dict[str, int] = {}
    for r in failed:
        k = failure_kind(r.failed)
        reasons[k] = reasons.get(k, 0) + 1
    tokens = sum(len(r.out_tokens or ()) for r in served)
    lat = [r.t_done_pc - r.t_submit_pc for r in served
           if r.t_done_pc > 0.0] or [0.0]
    return {"served": served, "tokens": tokens,
            "e2e_s": [float(x) for x in lat],
            "rejected": {"count": len(failed), "reasons": reasons,
                         "rids": sorted(r.rid for r in failed)}}


def page_codec_for(cfg, max_len: int, codec: Optional[str]):
    """The engine's page codec: the ``PageLayout``'s leaves become the
    codec's typed segments, so float KV leaves compress and integer
    counters pass through raw.  None for ``codec in (None, "none")``."""
    if codec is None or codec == "none":
        return None
    layout = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                            T.init_cache(cfg, 2, max_len, "meta"), 2)
    segs = [codecs.Segment(sp.offset, sp.nbytes, sp.dtype)
            for sp in layout.leaves if sp.nbytes]
    return codecs.make_codec(codec, layout.page_bytes, segs)


class ServeEngine:
    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 256, access_path: Optional[str] = None,
                 kv_backend: Optional[str] = None,
                 kv_shards: int = 1, kv_replicas: int = 1,
                 kv_kill_step: Optional[int] = None,
                 kv_nodes: Optional[int] = None, kv_doorbell: int = 4,
                 overlap: bool = True, overlap_grace_s: float = 0.002,
                 kv_node_latency_s: float = 0.0,
                 kv_retry: Optional[RetryPolicy] = None,
                 kv_integrity: bool = False,
                 fused_install: bool = True,
                 kv_codec: str = "none", prefix_share: bool = False,
                 prefix_pages: int = 8,
                 kv_capacity_bytes: Optional[int] = None, device=None):
        """``params`` must already live on ``device`` (default
        ``"cuda"``, which raises without a card)."""
        if kv_backend is not None:
            warnings.warn(
                "ServeEngine(kv_backend=...) is deprecated; use "
                "access_path='xdma'|'qdma'|'verbs'|'auto'",
                DeprecationWarning, stacklevel=2)
            if access_path is None:
                access_path = _KV_BACKEND_ALIAS[kv_backend]
        if kv_nodes is not None:
            # membership is the fabric's (sharded members, each a whole
            # path), so the old striped-nodes knob folds into it
            warnings.warn(
                "ServeEngine(kv_nodes=...) is deprecated; use "
                "kv_shards=N (fabric membership)", DeprecationWarning,
                stacklevel=2)
            if kv_shards == 1:
                kv_shards = kv_nodes
        if kv_shards < 1:
            raise ValueError(f"kv_shards must be >= 1, got {kv_shards}")
        if not 1 <= kv_replicas <= max(kv_shards, 1):
            raise ValueError(f"kv_replicas={kv_replicas} must be in "
                             f"[1, kv_shards={kv_shards}]")
        if kv_kill_step is not None and kv_replicas < 2:
            raise ValueError(
                "kv_kill_step without replication would lose pages: "
                "use kv_replicas >= 2")
        if access_path is None and (kv_shards > 1 or
                                    kv_kill_step is not None):
            # sharding implies paging, as on the CLI
            access_path = "xdma"
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.done: List[Request] = []
        self.prefill_1 = lm.make_prefill_step(cfg)
        self.decode = lm.make_decode_step(cfg)
        self.caches = T.init_cache(cfg, batch_slots, max_len, self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_left = np.zeros(batch_slots, np.int64)
        self.slot_pos = np.zeros(batch_slots, np.int64)
        self.cur_tokens = np.zeros((batch_slots, 1), np.int32)
        self.access_path = access_path
        self.overlap = overlap
        # grace: before decoding with installs pending, give their
        # fetches this long to settle
        self.overlap_grace_s = overlap_grace_s
        # admitted-but-nonresident slots: slot -> (req, first_tok, leaves,
        # structure) until the slot's page lands
        self._pending_install: Dict[int, Tuple] = {}
        self.overlap_installs = 0
        self.blocking_installs = 0
        self.fused_install = fused_install
        self._layout = pi.page_layout(
            T.init_cache(cfg, 1, max_len, "meta"),
            T.init_cache(cfg, batch_slots, max_len, "meta"), batch_slots)
        self._spill_buf: Optional[torch.Tensor] = None
        self.prefix_share = prefix_share
        self.prefix_pages = prefix_pages if prefix_share else 0
        # EWMA of the delta/encoded size ratio store_dedup achieved: the
        # estimate of a shared request's page cost (prior 0.5)
        self._share_ratio = 0.5
        self.install_fused = 0          # slots installed via the kernel
        self.install_fallback = 0       # ... vs the per-leaf chain
        self.install_hops_saved = 0     # per-leaf D2H readbacks avoided
        self._admit_spills: List[int] = []   # pages spilled this admit
        self.kv_shards = kv_shards
        self.kv_replicas = kv_replicas
        self.kv_kill_step = kv_kill_step
        self.shed_requests = 0
        self.fabric = None                  # ShardedPath when sharded
        self.fabric_mgr = None
        self.killed_member: Optional[str] = None
        self.kill_step: Optional[int] = None
        self.kill_repair: Optional[dict] = None
        self._step_no = 0
        self.ttft_hist = obs.LogHistogram()
        self.tpot_hist = obs.LogHistogram()
        self.queue_wait_hist = obs.LogHistogram()
        # fabric membership events, drained each step and stamped with
        # the decode step they landed in
        self.fabric_events: List[dict] = []
        self.pager: Optional[TieredStore] = None
        if access_path is not None:
            page_bytes = self._layout.page_bytes
            codec = page_codec_for(cfg, max_len, kv_codec)
            # the cold tier is sized in physical (encoded) bytes
            phys_bytes = codec.encoded_bytes if codec is not None \
                else page_bytes
            n_tier_pages = batch_slots + self.prefix_pages
            # registry factories drop kwargs their path doesn't take
            path_kw = dict(n_pages=n_tier_pages, page_bytes=phys_bytes,
                           n_channels=2, n_nodes=1,
                           doorbell_batch=kv_doorbell,
                           node_latency_s=kv_node_latency_s,
                           device=self.device)
            if kv_shards > 1:
                # N member paths behind one consistent-hash ShardedPath:
                # the store stays shard-oblivious, both hops ride it
                apath = create_path(
                    "fabric", member=access_path, shards=kv_shards,
                    replicas=kv_replicas, retry=kv_retry,
                    integrity=kv_integrity, **path_kw)
                self.fabric = apath
                self.fabric_mgr = FabricManager(apath)
            else:
                apath = create_path(access_path, **path_kw)
            # one retry layer, not two: the fabric retries and fails over
            # internally, a tier policy on top would multiply attempts
            self.pager = TieredStore(
                n_pages=n_tier_pages, page_shape=(page_bytes,),
                dtype="uint8", n_hot_slots=batch_slots, path=apath,
                retry=kv_retry if self.fabric is None else None,
                integrity=kv_integrity, codec=codec,
                shared_pool=range(batch_slots, n_tier_pages),
                capacity_bytes=kv_capacity_bytes)

    def submit(self, req: Request) -> None:
        req.t_submit_pc = time.perf_counter()
        req.out_tokens = []
        obs.async_begin("serve.request", req.rid,
                        prompt_len=len(req.prompt), max_new=req.max_new)
        self.queue.put(req)

    def kv_free_pages(self) -> int:
        """Free KV page capacity: slots unoccupied whose page is neither
        resident nor mid-fetch, capped by the store's physical-byte
        budget when ``kv_capacity_bytes`` is set (compressed or deduped
        pages leave more of it)."""
        if self.pager is None:
            return sum(1 for s in range(self.B)
                       if self.slot_req[s] is None
                       and s not in self._pending_install)
        free = 0
        for s in range(self.B):
            if self.slot_req[s] is not None or s in self._pending_install:
                continue
            if s in self.pager.slot_of_page or s in self.pager._prefetch:
                continue
            free += 1
        byte_free = self.pager.free_cold_bytes()
        if byte_free is not None:
            free = min(free, byte_free // max(self.pager.phys_page_bytes,
                                              1))
        return free

    def kv_page_cost(self, req: Request) -> float:
        """Effective KV page cost of admitting ``req``: 1.0 for a
        standalone page; for a shared-prefix request whose base is
        already published, the EWMA of the delta/encoded ratio
        ``store_dedup`` has achieved."""
        if self.pager is None or not self.prefix_share or \
                req.prefix_len <= 0:
            return 1.0
        key = req.prompt[:req.prefix_len].tobytes()
        if self.pager.lookup_shared(key) is None:
            return 1.0          # the first writer publishes a full base
        return self._share_ratio

    # -- paging ----------------------------------------------------------
    def _to_host(self, page: torch.Tensor) -> np.ndarray:
        """The packed page's one D2H, into a pinned buffer the engine
        reuses (the cold store copies it out before the next spill)."""
        if page.device.type == "cpu":
            return page.numpy()
        if self._spill_buf is None or \
                self._spill_buf.numel() != page.numel():
            self._spill_buf = torch.empty(page.numel(), dtype=torch.uint8,
                                          pin_memory=True)
        self._spill_buf.copy_(page, non_blocking=True)
        torch.cuda.current_stream(page.device).synchronize()
        return self._spill_buf.numpy()

    def _page_store(self, slot: int, req: Request, leaves) -> None:
        """Pack a slot's prefilled cache to one byte page and spill it to
        the cold tier (deduplicated against the shared base of its prompt
        prefix under ``prefix_share``); its prefetch starts with the
        admission round's."""
        if self.fused_install:
            packed = self._to_host(pi.pack_page(self._layout, leaves))
            self.install_hops_saved += max(0, len(leaves) - 1)
        else:
            packed = np.concatenate(
                [l.reshape(-1).view(torch.uint8).cpu().numpy()
                 for l in leaves])
        if self.prefix_share and req.prefix_len > 0:
            key = req.prompt[:req.prefix_len].tobytes()
            ratio = self.pager.store_dedup(slot, packed, key)
            self._share_ratio += 0.5 * (ratio - self._share_ratio)
        else:
            self.pager.write_page(slot, packed)
        self._admit_spills.append(slot)

    def _flush_spill_prefetch(self) -> None:
        """Start every page prefetch this admission round queued, in one
        call."""
        if self._admit_spills:
            self.pager.prefetch(self._admit_spills)
            self._admit_spills = []

    def _page_fetch(self, slot: int, leaves, spec):
        """Join the slot's prefetch and cut the device page back into
        cache leaves (plain PyTorch, leaf by leaf)."""
        dev_page = self.pager.ensure([slot])[slot]
        out, off = [], 0
        for l in leaves:
            n = l.numel() * l.element_size()
            out.append(dev_page[off:off + n].clone().view(l.dtype)
                       .reshape(l.shape))
            off += n
        return tree_unflatten(spec, out)

    # -- admission -------------------------------------------------------
    def _reject_overlong(self, req: Request, P: int) -> None:
        req.failed = (f"prompt length {P} >= engine max_len "
                      f"{self.max_len}")
        req.t_done_pc = time.perf_counter()
        self.done.append(req)
        obs.async_end("serve.request", req.rid, rejected=True)

    def _start_request(self, s: int, req: Request) -> None:
        """Admit ``req`` into slot ``s``: prefill, then either install
        inline (no paging) or spill + park pending-install."""
        req.t_admit_pc = time.perf_counter()
        qw = req.t_admit_pc - req.t_submit_pc
        self.queue_wait_hist.record(qw)
        if obs.metrics.live():
            reg = obs.default_registry()
            reg.histogram("serve.queue_wait_s").record(qw)
            reg.histogram(
                f"serve.tenant.{req.tenant}.queue_wait_s").record(qw)
        P = len(req.prompt)
        batch = {"tokens": torch.as_tensor(
            np.asarray(req.prompt, np.int32), device=self.device)[None]}
        with obs.span("serve.prefill", rid=req.rid, slot=s,
                      prompt_len=P):
            caches1 = T.init_cache(self.cfg, 1, self.max_len, self.device)
            caches1, logits = self.prefill_1(self.params, batch, caches1)
            tok = int(torch.argmax(logits[0]))
            if self.pager is not None:
                leaves, spec = tree_flatten(caches1)
                try:
                    self._page_store(s, req, leaves)
                except RETRIABLE as e:
                    self._shed(req, f"kv page store failed: {e}", slot=s)
                    return
                self._pending_install[s] = (req, tok, leaves, spec)
            else:
                self._install(s, req, tok, caches1)

    def _admit(self) -> None:
        """Fill free slots from the queue, FIFO (continuous batching);
        over-long prompts are rejected inline."""
        free = [s for s in range(self.B)
                if self.slot_req[s] is None
                and s not in self._pending_install]
        for s in free:
            req = None
            while req is None:
                try:
                    cand = self.queue.get_nowait()
                except queue.Empty:
                    break
                P = len(cand.prompt)
                if P >= self.max_len:
                    self._reject_overlong(cand, P)
                    continue
                req = cand
            if req is None:
                break
            self._start_request(s, req)
        if self.pager is not None:
            self._flush_spill_prefetch()

    # -- install ---------------------------------------------------------
    def _install(self, s: int, req: Request, tok: int, caches1) -> None:
        pi.install_slot(self._layout, tree_flatten(self.caches)[0],
                        tree_flatten(caches1)[0], s)
        self._install_meta(s, req, tok)

    def _install_meta(self, s: int, req: Request, tok: int) -> None:
        """Per-request bookkeeping after a slot's cache is installed."""
        self.slot_req[s] = req
        self.slot_left[s] = req.max_new - 1
        self.slot_pos[s] = len(req.prompt)
        self.cur_tokens[s, 0] = tok
        req.out_tokens.append(tok)
        # first token lands here: TTFT covers queueing + prefill + the
        # whole paging round trip (spill, cold fetch, H2C, install)
        req.t_first_pc = time.perf_counter()
        ttft = req.t_first_pc - req.t_submit_pc
        self.ttft_hist.record(ttft)
        if obs.metrics.live():
            reg = obs.default_registry()
            reg.histogram("serve.ttft_s").record(ttft)
            reg.histogram(f"serve.tenant.{req.tenant}.ttft_s").record(ttft)
        if obs.trace.enabled():
            obs.instant("serve.first_token", rid=req.rid, slot=s,
                        ttft_s=ttft)

    def _shed(self, req: Request, reason: str,
              slot: Optional[int] = None) -> None:
        """A paging op that stayed failed after retries sheds THIS
        request; the batch keeps decoding everyone else."""
        req.failed = reason
        req.t_done_pc = time.perf_counter()
        self.done.append(req)
        self.shed_requests += 1
        if slot is not None and self.pager is not None:
            self._pending_install.pop(slot, None)
            self.pager.drop_prefetch(slot)
            try:
                self.pager.release(slot, writeback=False)
            except Exception:
                pass        # the page is being abandoned either way
            try:
                self.pager.discard_cold(slot)
            except Exception:
                pass
        if obs.trace.enabled():
            obs.instant("serve.shed", rid=req.rid, reason=reason,
                        tenant=req.tenant)
        if obs.metrics.live():
            reg = obs.default_registry()
            reg.counter("serve.shed_requests").inc()
            reg.counter(
                f"serve.tenant.{req.tenant}.shed_requests").inc()
        obs.async_end("serve.request", req.rid, shed=True)

    def _install_ready(self, have_active: bool) -> None:
        """Move pending-install slots whose page fetch has settled into
        the decode batch (``overlap=False``: every pending slot, joining
        its fetch inline)."""
        if not self._pending_install:
            return
        pending = sorted(self._pending_install)
        if not self.overlap:
            ready = pending
            self.blocking_installs += len(ready)
        else:
            ready = [s for s in pending if self.pager.fetch_ready(s)]
            if not ready:
                # nothing landed: with other slots decodable, grant a
                # short grace; with nothing decodable, block until the
                # FIRST page lands
                cs = [c for s in pending
                      if (c := self.pager.fetch_completion(s)) is not None
                      and getattr(c, "reactive", True)]
                if cs:
                    try:
                        cplane.wait_any(
                            cs, timeout=self.overlap_grace_s
                            if have_active else 60.0)
                    except cplane.CompletionTimeout:
                        pass
                ready = [s for s in pending if self.pager.fetch_ready(s)]
            if ready:
                self.overlap_installs += len(ready)
            elif not have_active:
                # join one fetch inline so the loop always progresses
                ready = [pending[0]]
                self.blocking_installs += 1
        if not ready:
            return
        if self.fused_install:
            self._install_ready_fused(ready)
        else:
            for s in ready:
                self._install_one(s)

    def _install_one(self, s: int) -> None:
        """Per-leaf install for one slot: join its fetch, cut the device
        page into cache leaves, scatter leaf by leaf."""
        req, tok, leaves, spec = self._pending_install.pop(s)
        with obs.span("serve.install", rid=req.rid, slot=s,
                      path="fallback"):
            try:
                caches1 = self._page_fetch(s, leaves, spec)
            except RETRIABLE as e:
                self._shed(req, f"kv page fetch failed: {e}", slot=s)
                return
            self._install(s, req, tok, caches1)
            self.install_fallback += 1
            if obs.metrics.live():
                obs.default_registry().counter(
                    "serve.install_fallback").inc()

    def _install_ready_fused(self, ready: List[int]) -> None:
        """Install a group of settled slots through ONE install_pages
        call, straight from the staged ``(buffer, row)`` pairs; a group
        paging failure degrades to the per-slot path so only the slots
        whose fetch failed shed."""
        try:
            packed = self.pager.ensure_packed(ready)
        except RETRIABLE:
            for s in ready:
                self._install_one(s)
            return
        meta = [self._pending_install.pop(s) for s in ready]
        # split by staged representation: encoded rows install through
        # the codec's decode, raw ones (codec off, or delta pages rebuilt
        # on the host) as they are
        enc = [s for s in ready if self.pager.staged_encoded(s)]
        raw = [s for s in ready if s not in enc]
        with obs.span("serve.install", path="fused", slots=len(ready),
                      rids=[m[0].rid for m in meta]):
            leaves = tree_flatten(self.caches)[0]
            for group, codec in ((raw, None), (enc, self.pager.codec)):
                if group:
                    pi.install_pages(self._layout, leaves,
                                     [packed[s] for s in group], group,
                                     codec=codec)
        self.install_fused += len(ready)
        if obs.metrics.live():
            obs.default_registry().counter(
                "serve.install_fused").inc(len(ready))
        for s, (req, tok, _leaves, _spec) in zip(ready, meta):
            self._install_meta(s, req, tok)

    def _finish(self, req: Request) -> None:
        req.t_done_pc = time.perf_counter()
        self.done.append(req)
        n = len(req.out_tokens)
        if req.t_first_pc > 0.0 and n > 1:
            tpot = (req.t_done_pc - req.t_first_pc) / (n - 1)
            self.tpot_hist.record(tpot)
            if obs.metrics.live():
                reg = obs.default_registry()
                reg.histogram("serve.tpot_s").record(tpot)
                reg.histogram(
                    f"serve.tenant.{req.tenant}.tpot_s").record(tpot)
        obs.async_end("serve.request", req.rid, tokens=n)

    def _maybe_kill_node(self) -> None:
        """Fail one fabric member at the configured step (fault
        injection): reads fail over to replicas at once and the manager
        re-replicates onto the survivor ring inside this step — decode
        output stays bit-exact through it."""
        if self.fabric_mgr is None or self.kv_kill_step is None or \
                self.killed_member is not None or \
                self._step_no < self.kv_kill_step:
            return
        victim = self.fabric.alive_members()[-1]
        if obs.trace.enabled():
            obs.instant("serve.kill", member=victim, step=self._step_no)
        self.kill_repair = self.fabric_mgr.kill(victim)
        self.killed_member = victim
        self.kill_step = self._step_no

    def _drain_fabric_events(self) -> None:
        """Stamp the fabric's membership events (fail, epoch, ring flip,
        repair) with the decode step they landed in."""
        if self.fabric is None:
            return
        for ev in self.fabric.drain_events():
            ev["step"] = self._step_no
            self.fabric_events.append(ev)

    def step(self) -> int:
        """One batched decode step; returns #active slots."""
        self._step_no += 1
        self._maybe_kill_node()
        self._admit()
        if self.pager is not None:
            self._install_ready(any(r is not None for r in self.slot_req))
        self._drain_fabric_events()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return 0
        with obs.span("serve.decode_step", step=self._step_no,
                      active=len(active)):
            batch = {"tokens": torch.as_tensor(self.cur_tokens,
                                               device=self.device),
                     "pos": torch.as_tensor(self.slot_pos.astype(np.int32),
                                            device=self.device)[:, None]}
            self.caches, logits = self.decode(self.params, batch,
                                              self.caches)
            nxt = lm.greedy_sample(logits).cpu().numpy()
        for s in active:
            tok = int(nxt[s])
            req = self.slot_req[s]
            req.out_tokens.append(tok)
            self.slot_pos[s] += 1
            self.slot_left[s] -= 1
            if self.slot_left[s] <= 0:
                self._finish(req)
                self.slot_req[s] = None
                if self.pager is not None:
                    self.pager.release(s)
                    self.pager.discard_cold(s)
            else:
                self.cur_tokens[s, 0] = tok
        return len(active)

    def idle(self) -> bool:
        """True when nothing is queued, pending or active."""
        return (self.queue.empty() and not self._pending_install
                and all(r is None for r in self.slot_req))

    def undrained_count(self) -> int:
        return (self.queue.qsize()
                + sum(r is not None for r in self.slot_req)
                + len(self._pending_install))

    def run_until_drained(self, max_steps: int = 10000) -> int:
        """Step until every request finishes or ``max_steps`` runs out;
        returns the number of undrained requests (and warns if any)."""
        steps = 0
        while steps < max_steps:
            steps += 1
            if self.step() == 0 and self.idle():
                return 0
        left = self.undrained_count()
        if left:
            warnings.warn(
                f"run_until_drained: {left} requests still undrained "
                f"after max_steps={max_steps}", RuntimeWarning, stacklevel=2)
        return left

    def close(self) -> None:
        if self.pager is not None:
            self.pager.close()
