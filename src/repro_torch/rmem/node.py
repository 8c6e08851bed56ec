"""Far-memory nodes and the address map that stripes them.

Twin of ``repro/rmem/node.py``.  ``MemoryNode`` models one NIC-attached
DRAM pool: a server thread owning a flat byte pool, executing one-sided
WRs FIFO per doorbell — the DMA engine of an off-path SmartNIC
(arXiv:2212.07868).  Every WR crosses the node's link hop before its
bytes land in (or leave) the numpy pool, which stays byte-addressable
for verbs: the reference stages through its accelerator and reads the
bytes back; the port's hop is a copy onto the node's torch device and
back, a real H2D and D2H on the card (on the node's own CUDA stream,
which the node thread synchronises) and a host copy with
``device="cpu"``.  Runs of same-opcode WRs within one doorbell are
*coalesced*: the whole run is gathered into a single staged transfer,
so a doorbell of N batched reads or writes pays one hop instead of N
(``staged_hops`` and ``coalesced_runs`` count them as the reference
does).  Under an installed ``FaultPlan`` every WR runs on its own,
uncoalesced, and draws its own fault from the node's ``fault_scope``
(``name#N``, a process-wide counter as in the reference); an injected
bit-flip lands in the host buffer the hop just filled (the pool on a
write, the MR on a read), never in a device tensor.  The fabric stamps
its membership ``epoch`` into every node and address map it routes to.

``AddressMap`` is the SimBricks-memswitch routing table: ordered
``(vaddr_start, vaddr_end, node, phys_start)`` ranges; an access spanning a
range boundary is split across nodes, exactly like the exemplar's
``sw_mem_map`` striping one address space over several memory nodes.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.faults import injector as _faults
from repro_torch.rmem.verbs import OpCode, WorkRequest, _Doorbell


class MemoryNode:
    """One far-memory server: byte pool + WR-executing worker thread."""

    # fault-injection scope ids: names collide across backends (every
    # single-node RemoteBackend calls its node "memnode0"), so scopes
    # carry a process-unique suffix — a flap scheduled for one fabric
    # member must not take down every shard at once
    _scope_ids = itertools.count()

    def __init__(self, name: str, capacity_bytes: int, device=None,
                 latency_s: float = 0.0):
        """``latency_s`` models the link round trip the container cannot
        reproduce (the in-container device hop is µs where a far-memory
        RTT under load is ms): each *doorbell batch* pays it once before
        executing — per-doorbell, not per-WR, so batching amortizes it
        exactly as the paper's setup-cost model says.  ``device`` is
        where the link hop lands (default ``cuda``, which raises without
        a card)."""
        if capacity_bytes <= 0:
            raise ValueError(capacity_bytes)
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {latency_s}")
        self.name = name
        self.fault_scope = f"{name}#{next(MemoryNode._scope_ids)}"
        self.capacity_bytes = capacity_bytes
        self.latency_s = latency_s
        self.epoch = 0                      # fabric membership epoch
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None
        self.pool = np.zeros(capacity_bytes, np.uint8)
        self._brk = 0                       # bump allocator watermark
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"rmem-{name}")
        self._alive = True
        self.bytes_in = 0                   # one-sided writes landed
        self.bytes_out = 0                  # one-sided reads served
        self.ops = 0
        self.staged_hops = 0                # device transfers actually issued
        self.coalesced_runs = 0             # multi-WR runs served by one hop
        self._thread.start()

    # -- allocation ------------------------------------------------------
    def alloc(self, nbytes: int, align: int = 64) -> int:
        """Bump-allocate a region; returns its physical address."""
        if nbytes <= 0:
            raise ValueError(nbytes)
        addr = -(-self._brk // align) * align
        if addr + nbytes > self.capacity_bytes:
            raise MemoryError(f"{self.name}: {nbytes} B exceeds capacity "
                              f"({self._brk}/{self.capacity_bytes} used)")
        self._brk = addr + nbytes
        return addr

    @property
    def bytes_free(self) -> int:
        return self.capacity_bytes - self._brk

    def reset(self) -> None:
        """Release all allocations (bump allocator: watermark to zero).

        Callers own the invariant that no live region remains — e.g. a
        checkpoint node between retention epochs."""
        self._brk = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance this node's view of the fabric membership epoch.

        Epochs are monotonic — a decrease means a stale controller is
        trying to roll the membership back, which is exactly the split-
        brain the epoch exists to detect, so it raises."""
        if epoch < self.epoch:
            raise ValueError(f"{self.name}: epoch must be monotonic "
                             f"({epoch} < {self.epoch})")
        self.epoch = epoch

    # -- WR execution ----------------------------------------------------
    def execute(self, wrs: Sequence[WorkRequest], bell: _Doorbell) -> None:
        """Enqueue one routed doorbell batch for the server thread."""
        if not self._alive:
            raise RuntimeError(f"{self.name} is closed")
        self._q.put((list(wrs), bell))

    def _serve(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            wrs, bell = item
            if self.latency_s > 0:
                time.sleep(self.latency_s)      # modeled link RTT
            if _faults.ACTIVE:
                # per-WR execution under injection: each WR gets its own
                # fault draw, and a single injected error fails only its
                # WR — the coalesced-run fallback would re-execute (and
                # re-draw faults for) the whole run
                for wr in wrs:
                    err: Optional[Exception] = None
                    try:
                        self._execute_one(wr)
                    except Exception as e:
                        err = e
                    bell.wr_done(wr, err)
                continue
            # coalesce runs of same-opcode WRs: one staged device hop per
            # run (the doorbell amortization — N batched reads/writes cost
            # one hop instead of N)
            i = 0
            while i < len(wrs):
                j = i + 1
                while j < len(wrs) and wrs[j].opcode == wrs[i].opcode:
                    j += 1
                run = wrs[i:j]
                if len(run) == 1:
                    err: Optional[Exception] = None
                    try:
                        self._execute_one(run[0])
                    except Exception as e:
                        err = e
                    bell.wr_done(run[0], err)
                else:
                    self._execute_run(run, bell)
                i = j

    def _check_bounds(self, wr: WorkRequest) -> None:
        if wr.phys_addr < 0 or wr.phys_addr + wr.nbytes > self.capacity_bytes:
            raise IndexError(f"{self.name}: phys [{wr.phys_addr}, "
                             f"{wr.phys_addr + wr.nbytes}) out of pool")

    def _hop(self, host: np.ndarray) -> np.ndarray:
        """The link hop: ``host`` bytes onto the node's device and back
        (H2D then D2H on the node's stream, synchronised; a host copy on
        the CPU)."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        if self.stream is None:
            return src.clone().numpy()
        with torch.cuda.stream(self.stream):
            staged = src.to(self.device)
            back = staged.cpu()
        return back.numpy()

    def _execute_one(self, wr: WorkRequest) -> None:
        if _faults.ACTIVE:
            plan = _faults.current()
            if plan is not None:
                # may sleep (straggler) or raise a typed transient error
                # (flap window / injected completion error or timeout);
                # the error lands on exactly this WR via bell.wr_done
                plan.before_op(self.fault_scope)
        self._check_bounds(wr)
        self.ops += 1
        self.staged_hops += 1
        if wr.opcode == OpCode.WRITE:
            src = wr.mr.view(wr.local_offset, wr.nbytes)
            dst = self.pool[wr.phys_addr:wr.phys_addr + wr.nbytes]
            dst[:] = self._hop(src)                     # the link hop
            self.bytes_in += wr.nbytes
        else:
            dst = wr.mr.view(wr.local_offset, wr.nbytes)
            dst[:] = self._hop(
                self.pool[wr.phys_addr:wr.phys_addr + wr.nbytes])
            self.bytes_out += wr.nbytes
        if _faults.ACTIVE:
            plan = _faults.current()
            if plan is not None:
                # silent in-flight corruption: flip a bit in the host
                # buffer the hop just filled (pool on write, MR on read)
                # — only checksums can catch this
                plan.corrupt(self.fault_scope, dst)

    def _execute_run(self, run: Sequence[WorkRequest], bell: _Doorbell) \
            -> None:
        """Serve a same-opcode run with one gathered device transfer.

        On any failure the run falls back to per-WR execution so the error
        attaches to the precise WR; re-executing already-landed WRs is safe
        because one-sided reads/writes are idempotent.
        """
        try:
            for wr in run:
                self._check_bounds(wr)
                wr.mr.view(wr.local_offset, wr.nbytes)  # validate MR range
            if run[0].opcode == OpCode.WRITE:
                flat = self._hop(np.concatenate(
                    [wr.mr.view(wr.local_offset, wr.nbytes) for wr in run]))
                off = 0
                for wr in run:
                    self.pool[wr.phys_addr:wr.phys_addr + wr.nbytes] = \
                        flat[off:off + wr.nbytes]
                    self.bytes_in += wr.nbytes
                    off += wr.nbytes
            else:
                flat = self._hop(np.concatenate(
                    [self.pool[wr.phys_addr:wr.phys_addr + wr.nbytes]
                     for wr in run]))
                off = 0
                for wr in run:
                    wr.mr.view(wr.local_offset, wr.nbytes)[:] = \
                        flat[off:off + wr.nbytes]
                    self.bytes_out += wr.nbytes
                    off += wr.nbytes
            self.ops += len(run)
            self.staged_hops += 1
            self.coalesced_runs += 1
        except Exception:
            for wr in run:
                err: Optional[Exception] = None
                try:
                    self._execute_one(wr)
                except Exception as e:
                    err = e
                bell.wr_done(wr, err)
            return
        # deliver completions OUTSIDE the recovery path: an exception from
        # delivery itself (e.g. an INTERRUPT-mode callback raising) must
        # not trigger re-execution and double wr_done on a drained bell
        for wr in run:
            bell.wr_done(wr, None)

    def stats(self) -> dict:
        return {"name": self.name, "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out, "ops": self.ops,
                "staged_hops": self.staged_hops,
                "coalesced_runs": self.coalesced_runs,
                "allocated": self._brk, "capacity": self.capacity_bytes}

    def close(self) -> None:
        if self._alive:
            self._alive = False
            self._q.put(None)
            self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass(frozen=True)
class MapEntry:
    vaddr_start: int            # inclusive
    vaddr_end: int              # exclusive
    node: MemoryNode
    phys_start: int


class AddressMap:
    """Ordered virtual->physical routing table over memory nodes.

    Carries the fabric membership ``epoch``: the sharded fabric stamps
    every membership change (failure, ring flip) down into each
    member's map and nodes via ``set_epoch``, so any layer holding a
    routing view can compare epochs and detect that it is stale.
    """

    def __init__(self, entries: Sequence[MapEntry] = ()):
        self.entries: List[MapEntry] = []
        self.epoch = 0
        for e in entries:
            self.add_range(e.vaddr_start, e.vaddr_end, e.node, e.phys_start)

    def set_epoch(self, epoch: int) -> None:
        """Advance the membership epoch (monotonic) and stamp it onto
        every node this map routes to."""
        if epoch < self.epoch:
            raise ValueError(f"epoch must be monotonic "
                             f"({epoch} < {self.epoch})")
        self.epoch = epoch
        for node in self.nodes:
            node.set_epoch(epoch)

    def add_range(self, vaddr_start: int, vaddr_end: int, node: MemoryNode,
                  phys_start: int = 0) -> MapEntry:
        if vaddr_end <= vaddr_start or vaddr_start < 0:
            raise ValueError((vaddr_start, vaddr_end))
        if phys_start + (vaddr_end - vaddr_start) > node.capacity_bytes:
            raise ValueError(f"range exceeds {node.name} capacity")
        for e in self.entries:
            if vaddr_start < e.vaddr_end and e.vaddr_start < vaddr_end:
                raise ValueError(f"overlaps existing range "
                                 f"[{e.vaddr_start}, {e.vaddr_end})")
        entry = MapEntry(vaddr_start, vaddr_end, node, phys_start)
        self.entries.append(entry)
        self.entries.sort(key=lambda e: e.vaddr_start)
        return entry

    @property
    def nodes(self) -> List[MemoryNode]:
        seen, out = set(), []
        for e in self.entries:
            if id(e.node) not in seen:
                seen.add(id(e.node))
                out.append(e.node)
        return out

    def resolve(self, addr: int, nbytes: int) \
            -> List[Tuple[MemoryNode, int, int, int]]:
        """Route [addr, addr+nbytes) -> [(node, phys, nbytes, local_off)].

        Splits at range boundaries; raises on unmapped holes.
        """
        if nbytes <= 0:
            raise ValueError(nbytes)
        out: List[Tuple[MemoryNode, int, int, int]] = []
        pos = addr
        end = addr + nbytes
        for e in self.entries:
            if e.vaddr_end <= pos:
                continue
            if e.vaddr_start > pos:
                break                       # hole before next range
            n = min(end, e.vaddr_end) - pos
            out.append((e.node, e.phys_start + (pos - e.vaddr_start), n,
                        pos - addr))
            pos += n
            if pos >= end:
                return out
        raise ValueError(f"address [{pos}, {end}) unmapped")

    @classmethod
    def striped(cls, nodes: Sequence[MemoryNode], total_bytes: int,
                align: int = 64) -> "AddressMap":
        """Carve ``total_bytes`` contiguously across ``nodes`` (equal-ish
        extents, each bump-allocated on its node) — the memswitch layout."""
        if not nodes:
            raise ValueError("no nodes")
        amap = cls()
        per = -(-total_bytes // len(nodes))
        vaddr = 0
        for node in nodes:
            n = min(per, total_bytes - vaddr)
            if n <= 0:
                break
            phys = node.alloc(n, align=align)
            amap.add_range(vaddr, vaddr + n, node, phys)
            vaddr += n
        return amap
