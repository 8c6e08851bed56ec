"""Scatter-gather transfer descriptors (the XDMA/QDMA descriptor model).

Twin of ``repro/core/descriptors.py`` (no jax there either; copied so
the port imports nothing of the reference).

A ``Descriptor`` is one contiguous span ``(src_offset, dst_offset, nbytes)``
over flat buffers; a ``SGList`` is an ordered set of spans — exactly the
scatter-gather lists an XDMA engine walks (PG195), reused here for:

* sequence-packing batch gather (data pipeline),
* chunked multi-channel transfers (``channels.py`` splits SG lists across
  channels in round-robin, the paper's channel-interleaving),
* KV-page and optimizer-state offload moves.

Invariants (property-tested for the reference in
``tests/test_property.py``):
coalesce/chunk preserve total coverage and byte order; destinations of one
list never overlap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Descriptor:
    src_offset: int
    dst_offset: int
    nbytes: int

    def __post_init__(self):
        if self.nbytes <= 0 or self.src_offset < 0 or self.dst_offset < 0:
            raise ValueError(f"invalid descriptor {self}")


class SGList:
    """Ordered scatter-gather list with validation helpers."""

    def __init__(self, descs: Sequence[Descriptor] = ()):
        self.descs: List[Descriptor] = list(descs)

    def __len__(self) -> int:
        return len(self.descs)

    def __iter__(self):
        return iter(self.descs)

    @property
    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.descs)

    def append(self, src_offset: int, dst_offset: int, nbytes: int) -> None:
        self.descs.append(Descriptor(src_offset, dst_offset, nbytes))

    def validate(self, src_size: int | None = None,
                 dst_size: int | None = None) -> None:
        """Bounds + destination-overlap check."""
        spans = []
        for d in self.descs:
            if src_size is not None and d.src_offset + d.nbytes > src_size:
                raise ValueError(f"src overrun: {d} vs {src_size}")
            if dst_size is not None and d.dst_offset + d.nbytes > dst_size:
                raise ValueError(f"dst overrun: {d} vs {dst_size}")
            spans.append((d.dst_offset, d.dst_offset + d.nbytes))
        spans.sort()
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            if b0 < a1:
                raise ValueError(f"dst overlap at {b0} < {a1}")

    def coalesced(self) -> "SGList":
        """Merge spans contiguous in BOTH src and dst (fewer engine ops)."""
        out: List[Descriptor] = []
        for d in self.descs:
            if (out and out[-1].src_offset + out[-1].nbytes == d.src_offset
                    and out[-1].dst_offset + out[-1].nbytes == d.dst_offset):
                prev = out.pop()
                d = Descriptor(prev.src_offset, prev.dst_offset,
                               prev.nbytes + d.nbytes)
            out.append(d)
        return SGList(out)

    def chunked(self, max_bytes: int) -> "SGList":
        """Split spans larger than ``max_bytes`` (TLP/ring-slot sizing)."""
        if max_bytes <= 0:
            raise ValueError(max_bytes)
        out: List[Descriptor] = []
        for d in self.descs:
            off = 0
            while off < d.nbytes:
                n = min(max_bytes, d.nbytes - off)
                out.append(Descriptor(d.src_offset + off, d.dst_offset + off,
                                      n))
                off += n
        return SGList(out)

    def round_robin(self, n: int) -> List["SGList"]:
        """Interleave descriptors across ``n`` channels (XDMA model)."""
        lists: List[List[Descriptor]] = [[] for _ in range(n)]
        for i, d in enumerate(self.descs):
            lists[i % n].append(d)
        return [SGList(l) for l in lists]


def gather(src: np.ndarray, sg: SGList, dst: np.ndarray | None = None,
           dst_size: int | None = None) -> np.ndarray:
    """Execute an SG gather on host buffers (flat uint8 views)."""
    s = src.reshape(-1).view(np.uint8)
    if dst is None:
        size = dst_size if dst_size is not None else max(
            (d.dst_offset + d.nbytes for d in sg), default=0)
        dst = np.zeros(size, np.uint8)
    dview = dst.reshape(-1).view(np.uint8)
    sg.validate(src_size=s.size, dst_size=dview.size)
    for d in sg:
        dview[d.dst_offset:d.dst_offset + d.nbytes] = \
            s[d.src_offset:d.src_offset + d.nbytes]
    return dst


def spans_for_packing(doc_lengths: Sequence[int], seq_len: int,
                      itemsize: int = 4) -> Tuple[SGList, List[List[int]]]:
    """Build the SG list that packs variable-length docs into fixed rows.

    Greedy first-fit packing of documents (given as token lengths in a flat
    corpus laid out back-to-back) into rows of ``seq_len`` tokens.  Returns
    (sg_list in BYTES, per-row doc index lists).
    """
    sg = SGList()
    rows: List[List[int]] = [[]]
    row, col = 0, 0
    src_tok = 0
    for di, L in enumerate(doc_lengths):
        taken = 0
        while taken < L:
            if col == seq_len:
                row += 1
                col = 0
                rows.append([])
            n = min(L - taken, seq_len - col)
            sg.append((src_tok + taken) * itemsize,
                      (row * seq_len + col) * itemsize, n * itemsize)
            rows[row].append(di)
            col += n
            taken += n
        src_tok += L
    return sg, rows
