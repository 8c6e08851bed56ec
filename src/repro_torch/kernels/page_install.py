"""Page pack and page install between byte pages and the KV batch cache.

Twin of ``repro/kernels/page_install.py``.  ``PageLayout`` is the same
descriptor (byte offset, single-request shape, batch shape, dtype and
slot axis of every cache leaf), and a page has the same bytes: every
leaf's C-order bytes concatenated in tree-flatten order.

* ``pack_page`` gathers one slot's cache leaves into a (page_bytes,)
  uint8 page; the spill then needs a single D2H.
* ``install_pages`` scatters G staged pages into the batch cache leaves
  at ``slots``, in place.

On CUDA tensors both launch the CUDA C++ kernels of
``csrc/page_install.cu`` (one launch each, on the current stream) or
raise; on CPU tensors they run the plain PyTorch versions beside them,
``pack_page_torch`` and ``install_pages_torch``.  Nothing falls back from
the card to the plain version.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``.

``install_slot`` (the non-paging admission) stays plain PyTorch on every
device: the reference has no Pallas kernel there either.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.interop import dtype_name, torch_dtype, tree_flatten
from repro_torch.kernels import build

# ---------------------------------------------------------------------------
# layout descriptor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One cache leaf's place in the packed page.

    ``shape`` is the single-request leaf shape (size 1 at the slot
    axis); ``batch_shape`` the batch-tree leaf; ``slot_axis`` the axis
    where the batch leaf has size ``batch`` and the single leaf size 1
    (None = no such axis: the leaf merges by elementwise maximum, the
    "len" counter rule)."""
    index: int
    offset: int
    shape: Tuple[int, ...]
    batch_shape: Tuple[int, ...]
    dtype: str
    slot_axis: Optional[int]

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=torch_dtype(self.dtype)).element_size()

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.itemsize


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Static map from a packed byte page to a batch cache tree."""
    batch: int
    page_bytes: int
    leaves: Tuple[LeafSpec, ...]

    def kernel_groups(self) -> Dict[str, List[LeafSpec]]:
        """Leaves the install kernel takes, by dtype (the reference's
        rule): a slot axis exists, ranks agree, the leaf is not empty and
        its byte offset is aligned to its itemsize.  The CUDA kernel
        installs all of them in one launch, whatever their dtype."""
        groups: Dict[str, List[LeafSpec]] = {}
        for sp in self.leaves:
            if sp.slot_axis is None or len(sp.shape) != len(sp.batch_shape):
                continue
            if sp.offset % sp.itemsize or sp.nbytes == 0:
                continue
            groups.setdefault(sp.dtype, []).append(sp)
        return groups

    def fallback_indices(self) -> Tuple[int, ...]:
        """Leaf indices the install kernel skips (installed by plain
        PyTorch on the same device)."""
        covered = {sp.index for g in self.kernel_groups().values()
                   for sp in g}
        return tuple(sp.index for sp in self.leaves
                     if sp.index not in covered)


def _slot_axis(bshape, oshape, batch: int) -> Optional[int]:
    # the serving engine's structural rule: first axis where the batch
    # leaf has size B and the single-request leaf size 1
    return next((i for i, (x, y) in enumerate(zip(bshape, oshape))
                 if x == batch and y == 1), None)


_LAYOUT_CACHE: Dict[tuple, PageLayout] = {}


def page_layout(single_tree, batch_tree, batch: int) -> PageLayout:
    """Build (or fetch the cached) ``PageLayout`` for a cache config.

    Both trees are nested dicts of anything with ``shape`` and ``dtype``
    (tensors, numpy arrays) and must share a structure.  Cached by
    (structure, shapes, dtypes, batch)."""
    singles, sdef = tree_flatten(single_tree)
    batches, bdef = tree_flatten(batch_tree)
    if sdef != bdef or len(singles) != len(batches):
        raise ValueError(f"tree mismatch: {sdef} vs {bdef}")
    key = (str(sdef), batch,
           tuple((tuple(l.shape), dtype_name(l)) for l in singles),
           tuple((tuple(l.shape), dtype_name(l)) for l in batches))
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    specs, off = [], 0
    for i, (o, b) in enumerate(zip(singles, batches)):
        if dtype_name(o) != dtype_name(b):
            raise ValueError(f"leaf {i}: dtype mismatch {dtype_name(b)} "
                             f"vs {dtype_name(o)}")
        specs.append(LeafSpec(
            index=i, offset=off, shape=tuple(o.shape),
            batch_shape=tuple(b.shape), dtype=dtype_name(o),
            slot_axis=_slot_axis(b.shape, o.shape, batch)))
        off += specs[-1].nbytes
    layout = PageLayout(batch=batch, page_bytes=off, leaves=tuple(specs))
    _LAYOUT_CACHE[key] = layout
    return layout


# ---------------------------------------------------------------------------
# argument checks and the staged-page forms
# ---------------------------------------------------------------------------

def _device_of(tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def _check_leaf(sp: LeafSpec, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape) or dtype_name(t) != sp.dtype:
        raise ValueError(f"leaf {sp.index}: got {dtype_name(t)}"
                         f"{tuple(t.shape)}, layout wants {sp.dtype}"
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"leaf {sp.index} is not contiguous")


def _normalize_pages(layout: PageLayout, pages) -> List[Tuple[torch.Tensor,
                                                              int]]:
    """Accept a (G, page_bytes) uint8 tensor, one (page_bytes,) page, or
    a sequence of ``(buf, row)`` entries (``buf`` a (page_bytes,) page
    with row None, or a staged (Gk, page_bytes) group with ``row``
    selecting one page, as ``TieredStore.ensure_packed`` returns them).
    Returns (contiguous 2-D uint8 buffer, row) per page."""
    width = layout.page_bytes
    if isinstance(pages, torch.Tensor):
        pages = pages[None] if pages.ndim == 1 else pages
        entries = [(pages, g) for g in range(pages.shape[0])]
    else:
        entries = [(b if b.ndim == 2 else b[None], 0 if r is None else int(r))
                   for b, r in pages]
    for buf, row in entries:
        if buf.dtype != torch.uint8 or buf.shape[-1] != width:
            raise ValueError(f"page {buf.dtype}{tuple(buf.shape)}: want "
                             f"uint8 pages of {width} bytes")
        if not buf.is_contiguous():
            raise ValueError("staged pages must be contiguous")
        if not 0 <= row < buf.shape[0]:
            raise IndexError(f"row {row} of a {buf.shape[0]}-page group")
    return entries


def _check_slots(layout: PageLayout, slots, G: int) -> List[int]:
    slots = [int(s) for s in slots]
    if len(slots) != G:
        raise ValueError(f"{len(slots)} slots != {G} pages")
    if len(set(slots)) != G or not all(0 <= s < layout.batch
                                       for s in slots):
        raise ValueError(f"slots {slots} must be distinct and in "
                         f"[0, {layout.batch})")
    return slots


def _segment(buf: torch.Tensor, row: int, sp: LeafSpec) -> torch.Tensor:
    """Leaf ``sp`` of one staged page as a (single-request) tensor.  The
    clone gives the byte slice its own aligned storage for ``view``."""
    seg = buf[row, sp.offset:sp.offset + sp.nbytes].clone()
    return seg.view(torch_dtype(sp.dtype)).reshape(sp.shape)


def _install_leaf_torch(sp: LeafSpec, leaf: torch.Tensor,
                        val: torch.Tensor, slot: int) -> None:
    if sp.slot_axis is None:
        torch.maximum(leaf, val, out=leaf)
        return
    idx = torch.tensor([slot], dtype=torch.long, device=leaf.device)
    leaf.index_copy_(sp.slot_axis, idx, val)


def _launch_width(*values: int) -> int:
    """The widest copy word (16, 8, 4 or 1 bytes) that divides every
    address, offset and size of one leaf."""
    mixed = 0
    for v in values:
        mixed |= int(v)
    return next(w for w in (16, 8, 4, 1) if mixed % w == 0)


def _stream_ptr(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _table(rows: Sequence[Sequence[int]], dev: torch.device) -> torch.Tensor:
    """The launch table, rows of int64 laid end to end: built on the
    host, then one pinned H2D on the current stream (PyTorch keeps the
    pinned block reserved until that copy has run)."""
    host = torch.tensor([v for r in rows for v in r], dtype=torch.int64)
    return host.pin_memory().to(dev, non_blocking=True)


def _kernels() -> ctypes.CDLL:
    lib = build.load("page_install")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pack_page_launch.argtypes = [vp, i32, vp, i64, vp]
        lib.pack_page_launch.restype = i32
        lib.install_pages_launch.argtypes = [vp, i32, vp, i32, i64, vp]
        lib.install_pages_launch.restype = i32
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def pack_page_torch(layout: PageLayout, leaves) -> torch.Tensor:
    """Plain PyTorch pack: ``torch.cat`` of the leaves' byte views."""
    out = torch.cat([l.contiguous().reshape(-1).view(torch.uint8)
                     for l in leaves])
    if out.numel() != layout.page_bytes:
        raise ValueError(f"packed {out.numel()} != {layout.page_bytes}")
    return out


def _pack_cuda(layout: PageLayout, leaves, dev) -> torch.Tensor:
    page = torch.empty(layout.page_bytes, dtype=torch.uint8, device=dev)
    rows = []
    for sp, leaf in zip(layout.leaves, leaves):
        if sp.nbytes:
            w = _launch_width(leaf.data_ptr(), page.data_ptr() + sp.offset,
                              sp.nbytes)
            rows.append((leaf.data_ptr(), sp.offset, sp.nbytes, w))
    if not rows:
        return page
    table = _table(rows, dev)
    build.check(_kernels().pack_page_launch(
        table.data_ptr(), len(rows), page.data_ptr(),
        max(n // w for _, _, n, w in rows), _stream_ptr(dev)),
        "pack_page")
    pack_page.launches += 1
    return page


def pack_page(layout: PageLayout, leaves) -> torch.Tensor:
    """Pack one slot's cache leaves (tree-flatten order, single-request
    shapes) into a (page_bytes,) uint8 page on their device."""
    leaves = tuple(leaves)
    if len(leaves) != len(layout.leaves):
        raise ValueError(f"{len(leaves)} leaves != layout "
                         f"{len(layout.leaves)}")
    for sp, leaf in zip(layout.leaves, leaves):
        _check_leaf(sp, leaf, sp.shape)
    dev = _device_of(leaves)
    if dev.type == "cpu":
        return pack_page_torch(layout, leaves)
    if dev.type != "cuda":
        raise ValueError(f"pack_page runs on cuda or cpu, not {dev}")
    return _pack_cuda(layout, leaves, dev)


pack_page.launches = 0


# ---------------------------------------------------------------------------
# install
# ---------------------------------------------------------------------------

def install_pages_torch(layout: PageLayout, batch_leaves, pages, slots,
                        only: Optional[Sequence[int]] = None):
    """Plain PyTorch install, per page and leaf: slice the page, view it
    as the leaf's dtype, then ``index_copy_`` at the slot (or ``max`` for
    a leaf with no slot axis).  In place; returns ``batch_leaves``.
    ``only`` restricts it to those leaf indices."""
    entries = _normalize_pages(layout, pages)
    slots = _check_slots(layout, slots, len(entries))
    keep = None if only is None else set(only)
    for (buf, row), slot in zip(entries, slots):
        for sp in layout.leaves:
            if keep is None or sp.index in keep:
                _install_leaf_torch(sp, batch_leaves[sp.index],
                                    _segment(buf, row, sp), slot)
    return batch_leaves


def _install_cuda(layout: PageLayout, batch_leaves, entries, slots,
                  dev) -> None:
    addrs = [buf.data_ptr() + row * layout.page_bytes for buf, row in entries]
    rows = []
    max_words = 0
    for specs in layout.kernel_groups().values():
        for sp in specs:
            leaf = batch_leaves[sp.index]
            ax = sp.slot_axis
            outer = int(np.prod(sp.batch_shape[:ax], dtype=np.int64))
            inner = int(np.prod(sp.batch_shape[ax + 1:], dtype=np.int64)) \
                * sp.itemsize
            w = _launch_width(leaf.data_ptr(), sp.offset, inner,
                              *addrs)
            rows.append((leaf.data_ptr(), sp.offset, outer, inner, w,
                         layout.batch))
            max_words = max(max_words, outer * inner // w)
    if not rows:
        return
    # one table: six int64 per leaf, then two per page
    table = _table(rows + list(zip(addrs, slots)), dev)
    build.check(_kernels().install_pages_launch(
        table.data_ptr(), len(rows), table.data_ptr() + 6 * 8 * len(rows),
        len(entries), max_words, _stream_ptr(dev)), "install_pages")
    install_pages.launches += 1


def install_pages(layout: PageLayout, batch_leaves, pages, slots, *,
                  codec=None):
    """Scatter G staged pages into the batch cache leaves at ``slots``,
    in place; returns ``batch_leaves`` (tree-flatten order).

    ``pages`` takes every form ``_normalize_pages`` does.  Slots must be
    distinct.  On CUDA the leaves of ``layout.kernel_groups()`` install
    in one kernel launch; the rest (``fallback_indices()``: no slot axis,
    or an offset not aligned to the itemsize) install through the plain
    version on the same device, after it on the same stream."""
    if codec is not None:
        raise NotImplementedError("install_pages(codec=...): the dequant "
                                  "epilogue waits for the codec slice")
    batch_leaves = list(batch_leaves)
    if len(batch_leaves) != len(layout.leaves):
        raise ValueError(f"{len(batch_leaves)} leaves != layout "
                         f"{len(layout.leaves)}")
    for sp, leaf in zip(layout.leaves, batch_leaves):
        _check_leaf(sp, leaf, sp.batch_shape)
    entries = _normalize_pages(layout, pages)
    slots = _check_slots(layout, slots, len(entries))
    dev = _device_of(batch_leaves + [b for b, _ in entries])
    if dev.type == "cpu":
        return install_pages_torch(layout, batch_leaves, entries, slots)
    if dev.type != "cuda":
        raise ValueError(f"install_pages runs on cuda or cpu, not {dev}")
    _install_cuda(layout, batch_leaves, entries, slots, dev)
    rest = layout.fallback_indices()
    if rest:
        install_pages_torch(layout, batch_leaves, entries, slots, only=rest)
    return batch_leaves


install_pages.launches = 0


def install_slot(layout: PageLayout, batch_leaves, single_leaves,
                 slot: int):
    """Install one single-request cache tree into the batch leaves at
    ``slot``, in place (``index_copy_``, or ``max`` for a leaf with no
    slot axis); returns ``batch_leaves``."""
    batch_leaves = list(batch_leaves)
    single_leaves = list(single_leaves)
    if len(batch_leaves) != len(layout.leaves) or \
            len(single_leaves) != len(layout.leaves):
        raise ValueError("leaf count != layout")
    for sp in layout.leaves:
        _install_leaf_torch(sp, batch_leaves[sp.index],
                            single_leaves[sp.index], slot)
    return batch_leaves
