"""Batched serving engine: continuous slot-based batching with KV paging.

Twin of ``repro/serving/engine.py`` for one engine over one access path.
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

Not in this slice: the admission controller, the sharded fabric, page
codecs and prefix sharing.
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
from repro_torch.faults.retry import RETRIABLE
from repro_torch.interop import tree_flatten, tree_unflatten
from repro_torch.kernels import page_install as pi
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.rmem.store import TieredStore


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new: int = 16
    out_tokens: Optional[List[int]] = None
    failed: Optional[str] = None       # rejection reason (engine kept going)
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


class ServeEngine:
    def __init__(self, cfg, params, batch_slots: int = 4,
                 max_len: int = 256, access_path: Optional[str] = None,
                 kv_doorbell: int = 4,
                 overlap: bool = True, overlap_grace_s: float = 0.002,
                 fused_install: bool = True, device=None):
        """``params`` must already live on ``device`` (default
        ``"cuda"``, which raises without a card)."""
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
        self.install_fused = 0          # slots installed via the kernel
        self.install_fallback = 0       # ... vs the per-leaf chain
        self.install_hops_saved = 0     # per-leaf D2H readbacks avoided
        self._admit_spills: List[int] = []   # pages spilled this admit
        self.shed_requests = 0
        self._step_no = 0
        self.ttft_hist = obs.LogHistogram()
        self.tpot_hist = obs.LogHistogram()
        self.queue_wait_hist = obs.LogHistogram()
        self.pager: Optional[TieredStore] = None
        if access_path is not None:
            page_bytes = self._layout.page_bytes
            apath = create_path(access_path, n_pages=batch_slots,
                                page_bytes=page_bytes, n_channels=2,
                                n_nodes=1, doorbell_batch=kv_doorbell,
                                device=self.device)
            self.pager = TieredStore(
                n_pages=batch_slots, page_shape=(page_bytes,),
                dtype="uint8", n_hot_slots=batch_slots, path=apath)

    def submit(self, req: Request) -> None:
        req.t_submit_pc = time.perf_counter()
        req.out_tokens = []
        obs.async_begin("serve.request", req.rid,
                        prompt_len=len(req.prompt), max_new=req.max_new)
        self.queue.put(req)

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

    def _page_store(self, slot: int, leaves) -> None:
        """Pack a slot's prefilled cache to one byte page and spill it to
        the cold tier; its prefetch starts with the admission round's."""
        if self.fused_install:
            packed = self._to_host(pi.pack_page(self._layout, leaves))
            self.install_hops_saved += max(0, len(leaves) - 1)
        else:
            packed = np.concatenate(
                [l.reshape(-1).view(torch.uint8).cpu().numpy()
                 for l in leaves])
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
        self.queue_wait_hist.record(req.t_admit_pc - req.t_submit_pc)
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
                    self._page_store(s, leaves)
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
            self.pager.release(slot)
            self.pager.discard_cold(slot)
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
        with obs.span("serve.install", path="fused", slots=len(ready),
                      rids=[m[0].rid for m in meta]):
            pi.install_pages(self._layout, tree_flatten(self.caches)[0],
                             [packed[s] for s in ready], ready)
        self.install_fused += len(ready)
        for s, (req, tok, _leaves, _spec) in zip(ready, meta):
            self._install_meta(s, req, tok)

    def _finish(self, req: Request) -> None:
        req.t_done_pc = time.perf_counter()
        self.done.append(req)
        n = len(req.out_tokens)
        if req.t_first_pc > 0.0 and n > 1:
            self.tpot_hist.record((req.t_done_pc - req.t_first_pc) / (n - 1))
        obs.async_end("serve.request", req.rid, tokens=n)

    def step(self) -> int:
        """One batched decode step; returns #active slots."""
        self._step_no += 1
        self._admit()
        if self.pager is not None:
            self._install_ready(any(r is not None for r in self.slot_req))
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
