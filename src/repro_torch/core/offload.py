"""Host offload built on the NMA engine: optimizer state + KV-cache paging.

Twin of ``repro/core/offload.py``: the two production uses of the colder
memory tiers, the SmartNIC-DRAM pattern of the paper's Table 1
workloads, with the ``ChannelPool`` playing the XDMA engine.

``HostOffloadedOptimizer`` keeps the AdamW moments in host RAM.  Each
step streams them in (while leaf i updates on the card, leaf i+1 is in
flight H2C), updates, and streams them back C2H, with one barrier over
the whole drain.  Host leaves are CPU tensors (``core.engine``'s note:
bf16 moments keep every bit).

``KVPager`` is the deprecated alias of ``repro_torch.rmem.TieredStore``
with the ``n_hbm_slots`` spelling.  Its default ``dtype`` is float32,
where the reference's is bfloat16: the port's store types its pages
through numpy, which has no bfloat16.
"""
from __future__ import annotations

import warnings
from typing import Any, List, Optional, Tuple

from repro_torch.core.engine import MemoryEngine, c2h_leaf
from repro_torch.cplane import wait_all
from repro_torch.interop import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.rmem.backend import TierBackend
from repro_torch.rmem.store import TieredStore


class HostOffloadedOptimizer:
    """Wraps ``repro_torch.optim.adamw.AdamW`` with host-resident state.

    State streams through an access path: ``path`` names it
    ("xdma"/"qdma"/"auto"/...) or passes a constructed ``MemoryPath``.
    The default ``auto`` is a stage-only selector over the two DMA
    members.  ``device`` is the engine's (None means ``"cuda"``); the
    params must lie on it."""

    def __init__(self, opt, params, engine: Optional[MemoryEngine] = None,
                 n_channels: int = 4, path="auto", device=None):
        self.opt = opt
        self.engine = engine or MemoryEngine(n_channels=n_channels,
                                             path=path, device=device)
        dev_state = opt.init(params)
        # spill the initial state to the host (C2H)
        self.host_state = self.engine.read_tree(dev_state)
        del dev_state

    def _leaf_update(self, p, g, m, v, step):
        new_p, new_s = self.opt.update({"x": p}, {"x": g},
                                       {"m": {"x": m}, "v": {"x": v}}, step)
        return new_p["x"], new_s["m"]["x"], new_s["v"]["x"]

    def step(self, params, grads, step_idx) -> Any:
        """Streamed update: H2C(state i+1) overlaps update(state i)."""
        p_leaves, spec = tree_flatten(params)
        g_leaves = tree_leaves(grads)
        m_host = tree_leaves(self.host_state["m"])
        v_host = tree_leaves(self.host_state["v"])
        n = len(p_leaves)

        # prefetch the first leaf, then pipeline
        inflight = [None] * n
        inflight[0] = (self.engine.write(m_host[0]),
                       self.engine.write(v_host[0]))
        new_p = []
        c2h: List[Tuple[Any, Any, Any, Any]] = []
        for i in range(n):
            if i + 1 < n:
                inflight[i + 1] = (self.engine.write(m_host[i + 1]),
                                   self.engine.write(v_host[i + 1]))
            m_dev = inflight[i][0].wait()
            v_dev = inflight[i][1].wait()
            inflight[i] = None
            p2, m2, v2 = self._leaf_update(p_leaves[i], g_leaves[i],
                                           m_dev, v_dev, step_idx)
            del m_dev, v_dev
            new_p.append(p2)
            c2h.append(c2h_leaf(self.engine, m2) + c2h_leaf(self.engine, v2))
        # one barrier over the whole C2H drain, then collect in leaf order
        wait_all([t for tm, _, tv, _ in c2h for t in (tm, tv)])
        mspec = tree_flatten(self.host_state["m"])[1]
        self.host_state = {
            "m": tree_unflatten(mspec, [fm(tm.result())
                                        for tm, fm, _, _ in c2h]),
            "v": tree_unflatten(mspec, [fv(tv.result())
                                        for _, _, tv, fv in c2h])}
        return tree_unflatten(spec, new_p)

    def host_bytes(self) -> int:
        return sum(l.nbytes for l in tree_leaves(self.host_state))

    def close(self) -> None:
        self.engine.close()


class KVPager(TieredStore):
    """Page-granular KV residency: HBM slots over a pluggable cold tier
    (deprecated: ``TieredStore`` with ``n_hot_slots``)."""

    def __init__(self, n_pages: int, page_shape: Tuple[int, ...],
                 dtype="float32", n_hbm_slots: int = 8,
                 engine: Optional[MemoryEngine] = None,
                 backend: Optional[TierBackend] = None, path=None, **kw):
        warnings.warn(
            "KVPager is deprecated; use repro_torch.rmem.TieredStore (same "
            "API, n_hot_slots instead of n_hbm_slots) with an access path, "
            "e.g. TieredStore(..., path='xdma'|'verbs'|'auto')",
            DeprecationWarning, stacklevel=2)
        super().__init__(n_pages, page_shape, dtype=dtype,
                         n_hot_slots=n_hbm_slots, engine=engine,
                         backend=backend, path=path, **kw)

    @property
    def n_hbm_slots(self) -> int:
        return self.n_hot_slots

    @property
    def host(self):
        """Typed view of the local-host cold store."""
        mem = getattr(self.backend, "mem", None)
        if mem is None:
            raise AttributeError(
                "KVPager.host only exists with a LocalHostBackend")
        return mem.view(self._np_dtype).reshape(
            (self.n_pages,) + self.page_shape)
