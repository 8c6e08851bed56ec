"""Page pack and page install between byte pages and the KV batch cache.

Twin of ``repro/kernels/page_install.py``.  ``PageLayout`` is the same
descriptor (byte offset, single-request shape, batch shape, dtype and
slot axis of every cache leaf), and a page has the same bytes: every
leaf's C-order bytes concatenated in tree-flatten order.

* ``pack_page`` gathers one slot's cache leaves into a (page_bytes,)
  uint8 page; the spill then needs a single D2H.
* ``install_pages`` scatters G staged pages into the batch cache leaves
  at ``slots``, in place; with ``codec=`` the staged pages are encoded
  (``rmem/codec.py``) and are decoded on their device first.

On CUDA tensors both launch the CUDA C++ kernels of
``csrc/page_install.cu`` on the current stream, or raise, each with its
launch table passed in the launch's parameters (no H2D, no allocation
per call): the pack one launch per ``MAX_PACK_LEAVES`` non-empty leaves
(``pack_tables``), the install one launch per ``MAX_INSTALL_LEAVES``
leaves and ``MAX_INSTALL_PAGES`` pages (``install_tables``); on CPU
tensors they run the plain PyTorch versions beside them,
``pack_page_torch`` and ``install_pages_torch``.  Nothing falls back from
the card to the plain version.  Each wrapper counts its kernel launches
in ``<wrapper>.launches``.

``install_slot`` (the non-paging admission) stays plain PyTorch on every
device: the reference has no Pallas kernel there either.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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

    @functools.cached_property
    def itemsize(self) -> int:
        return torch.empty((), dtype=torch_dtype(self.dtype)).element_size()

    @functools.cached_property
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
        for sp in self.install_rows:
            groups.setdefault(sp.dtype, []).append(sp)
        return groups

    @functools.cached_property
    def install_rows(self) -> Tuple[LeafSpec, ...]:
        """The kernel's leaves (``kernel_groups``) in page order, computed
        once per layout: the install's host side runs on every call."""
        return tuple(
            sp for sp in self.leaves
            if sp.slot_axis is not None
            and len(sp.shape) == len(sp.batch_shape)
            and not sp.offset % sp.itemsize and sp.nbytes)

    @functools.cached_property
    def row_geometry(self) -> Tuple[Tuple[LeafSpec, int, int], ...]:
        """``(leaf, outer, inner)`` of each kernel leaf: its batch leaf
        viewed as ``(outer, batch, inner bytes)`` around the slot axis."""
        out = []
        for sp in self.install_rows:
            ax = sp.slot_axis
            out.append((sp, int(np.prod(sp.batch_shape[:ax], dtype=np.int64)),
                        int(np.prod(sp.batch_shape[ax + 1:], dtype=np.int64))
                        * sp.itemsize))
        return tuple(out)

    def fallback_indices(self) -> Tuple[int, ...]:
        """Leaf indices the install kernel skips (installed by plain
        PyTorch on the same device)."""
        covered = {sp.index for sp in self.install_rows}
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


def _normalize_pages(layout: PageLayout, pages, width: Optional[int] = None
                     ) -> List[Tuple[torch.Tensor, int]]:
    """Accept a (G, width) uint8 tensor, one (width,) page, or a sequence
    of ``(buf, row)`` entries (``buf`` a (width,) page with row None, or
    a staged (Gk, width) group with ``row`` selecting one page, as
    ``TieredStore.ensure_packed`` returns them).  ``width`` defaults to
    ``layout.page_bytes`` (a codec's encoded pages are narrower).
    Returns (contiguous 2-D uint8 buffer, row) per page."""
    width = layout.page_bytes if width is None else width
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
    """Slots as ints, one per page, each in ``[0, batch)``.  A slot may
    repeat: pages install in order, so the last page for a slot wins, as
    in the reference."""
    slots = [int(s) for s in slots]
    if len(slots) != G:
        raise ValueError(f"{len(slots)} slots != {G} pages")
    if not all(0 <= s < layout.batch for s in slots):
        raise ValueError(f"slots {slots} must lie in [0, {layout.batch})")
    return slots


def _last_per_slot(slots: Sequence[int]) -> List[int]:
    """Indices of the pages that survive an in-order install: the last
    page for each slot, in page order."""
    last = {s: g for g, s in enumerate(slots)}
    return sorted(last.values())


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


# the pack's launch struct, as csrc/page_install.cu declares it
PACK_THREADS = 256            # kThreads
PACK_UNROLL = 4               # kPackUnroll: words a thread copies
PACK_BLOCK_WORDS = PACK_THREADS * PACK_UNROLL
MAX_PACK_LEAVES = 120         # kMaxPackLeaves: the table fits 4,096 bytes


class PackLeaf(ctypes.Structure):
    """``PackLeaf`` of csrc/page_install.cu."""
    _fields_ = [("src", ctypes.c_int64), ("page_offset", ctypes.c_int64),
                ("nbytes", ctypes.c_int64), ("width", ctypes.c_int32),
                ("first_block", ctypes.c_int32)]


class PackTable(ctypes.Structure):
    """``PackTable`` of csrc/page_install.cu, passed to the kernel by
    value as a ``__grid_constant__`` parameter."""
    _fields_ = [("n", ctypes.c_int32), ("blocks", ctypes.c_int32),
                ("leaf", PackLeaf * MAX_PACK_LEAVES)]


def pack_tables(layout: PageLayout, src_ptrs: Sequence[int],
                page_ptr: int) -> List[PackTable]:
    """The pack's launches: one table per ``MAX_PACK_LEAVES`` non-empty
    leaves, in tree-flatten order.  Each entry holds the leaf's source
    address, its offset in the page, its size, its copy word
    (``_launch_width``) and its first block of the launch's flat grid
    (``PACK_BLOCK_WORDS`` words a block)."""
    rows = [(int(ptr), sp.offset, sp.nbytes,
             _launch_width(ptr, page_ptr + sp.offset, sp.nbytes))
            for sp, ptr in zip(layout.leaves, src_ptrs) if sp.nbytes]
    tables = []
    for c in range(0, len(rows), MAX_PACK_LEAVES):
        chunk = rows[c:c + MAX_PACK_LEAVES]
        t = PackTable(n=len(chunk))
        first = 0
        for i, (src, off, nbytes, w) in enumerate(chunk):
            t.leaf[i] = PackLeaf(src, off, nbytes, w, first)
            first += -(-(nbytes // w) // PACK_BLOCK_WORDS)
        t.blocks = first
        tables.append(t)
    return tables


# the install's launch struct, as csrc/page_install.cu declares it
INSTALL_UNROLL = 4            # kInstallUnroll: words a thread copies
INSTALL_BLOCK_WORDS = PACK_THREADS * INSTALL_UNROLL
MAX_INSTALL_LEAVES = 32       # kMaxInstallLeaves
MAX_INSTALL_PAGES = 128       # kMaxInstallPages: the table fits 4,096 bytes


class InstallLeaf(ctypes.Structure):
    """``InstallLeaf`` of csrc/page_install.cu."""
    _fields_ = [("dst", ctypes.c_int64), ("page_offset", ctypes.c_int64),
                ("inner", ctypes.c_int64), ("outer", ctypes.c_int32),
                ("width", ctypes.c_int32), ("row_blocks", ctypes.c_int32),
                ("rows_per_block", ctypes.c_int32),
                ("first_block", ctypes.c_int32), ("pad", ctypes.c_int32)]


class InstallPage(ctypes.Structure):
    """``InstallPage`` of csrc/page_install.cu."""
    _fields_ = [("addr", ctypes.c_int64), ("slot", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


class InstallTable(ctypes.Structure):
    """``InstallTable`` of csrc/page_install.cu, passed to the kernel by
    value as a ``__grid_constant__`` parameter."""
    _fields_ = [("n_leaves", ctypes.c_int32), ("n_pages", ctypes.c_int32),
                ("page_blocks", ctypes.c_int32), ("batch", ctypes.c_int32),
                ("leaf", InstallLeaf * MAX_INSTALL_LEAVES),
                ("page", InstallPage * MAX_INSTALL_PAGES)]


def install_blocks(inner: int, outer: int, width: int
                   ) -> Tuple[int, int, int]:
    """``(row_blocks, rows_per_block, blocks)`` of one leaf: rows of at
    least ``INSTALL_BLOCK_WORDS`` words are cut into ``row_blocks``
    blocks each, shorter rows go ``rows_per_block`` whole rows a
    block."""
    row_words = inner // width
    if row_words >= INSTALL_BLOCK_WORDS:
        rb = -(-row_words // INSTALL_BLOCK_WORDS)
        return rb, 0, outer * rb
    rpb = INSTALL_BLOCK_WORDS // row_words
    return 0, rpb, -(-outer // rpb)


def install_tables(layout: PageLayout, dst_ptrs: Sequence[int],
                   page_addrs: Sequence[int], slots: Sequence[int]
                   ) -> Tuple[List[InstallTable], bool]:
    """The install's launches, and whether they need 64-bit indices.

    ``dst_ptrs`` are the batch leaves' addresses (tree-flatten order),
    ``page_addrs`` the staged pages' first bytes and ``slots`` their
    slots, which must be distinct.  The leaves of
    ``layout.kernel_groups()`` go in page-offset order, each with its
    copy word (``_launch_width``: the widest word dividing its address,
    its offset in every page and its row bytes) and its blocks
    (``install_blocks``); one table per ``MAX_INSTALL_LEAVES`` leaves
    and ``MAX_INSTALL_PAGES`` pages."""
    if len(set(slots)) != len(slots) or len(slots) != len(page_addrs):
        raise ValueError(f"install tables want one page per distinct "
                         f"slot, got slots {list(slots)}")
    rows, wide = [], False
    pages_or = _launch_width(*page_addrs)     # the pages' common alignment
    for sp, outer, inner in layout.row_geometry:
        if outer >= 2 ** 31:
            raise ValueError(f"leaf {sp.index}: {outer} rows")
        dst = int(dst_ptrs[sp.index])
        w = _launch_width(dst, sp.offset, inner, pages_or)
        rows.append((dst, sp.offset, inner, outer, w,
                     *install_blocks(inner, outer, w)))
        wide |= outer * layout.batch * inner >= 2 ** 31
    tables = []
    for c in range(0, len(rows), MAX_INSTALL_LEAVES):
        chunk = rows[c:c + MAX_INSTALL_LEAVES]
        for p in range(0, len(page_addrs), MAX_INSTALL_PAGES):
            pages = list(zip(page_addrs, slots))[p:p + MAX_INSTALL_PAGES]
            t = InstallTable(n_leaves=len(chunk), n_pages=len(pages),
                             batch=layout.batch)
            first = 0
            for i, (dst, off, inner, outer, w, rb, rpb, nb) in \
                    enumerate(chunk):
                t.leaf[i] = InstallLeaf(dst, off, inner, outer, w, rb, rpb,
                                        first)
                first += nb
            t.page_blocks = first
            for g, (addr, slot) in enumerate(pages):
                t.page[g] = InstallPage(int(addr), int(slot))
            tables.append(t)
    return tables, wide


def _kernels() -> ctypes.CDLL:
    lib = build.load("page_install")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pack_page_launch.argtypes = [ctypes.POINTER(PackTable), vp,
                                         i32, vp]
        lib.pack_page_launch.restype = i32
        lib.install_pages_launch.argtypes = [ctypes.POINTER(InstallTable),
                                             i32, vp]
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
    wide = int(layout.page_bytes >= 2 ** 31)
    for table in pack_tables(layout, [l.data_ptr() for l in leaves],
                             page.data_ptr()):
        build.check(_kernels().pack_page_launch(
            ctypes.byref(table), page.data_ptr(), wide, _stream_ptr(dev)),
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
    a leaf with no slot axis).  Pages go in order, so the last page for a
    repeated slot wins.  In place; returns ``batch_leaves``.
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
    # the kernel writes every page at once, so an earlier page for a slot
    # that repeats is dropped here: each slot is written once, by its last
    keep = _last_per_slot(slots)
    addrs = [entries[g][0].data_ptr() + entries[g][1] * layout.page_bytes
             for g in keep]
    if not layout.install_rows:
        return
    tables, wide = install_tables(layout,
                                  [l.data_ptr() for l in batch_leaves],
                                  addrs, [slots[g] for g in keep])
    for table in tables:
        build.check(_kernels().install_pages_launch(
            ctypes.byref(table), int(wide), _stream_ptr(dev)),
            "install_pages")
        install_pages.launches += 1


def _codec_seg(codec, sp: LeafSpec):
    """The codec segment backing a layout leaf: offsets, widths and
    dtypes must agree, or the encoded page was built for another tree."""
    seg = codec.seg_at(sp.offset)
    if seg is None or seg.nbytes != sp.nbytes or seg.dtype != sp.dtype:
        raise ValueError(f"codec segment mismatch at byte {sp.offset}: "
                         f"layout leaf {sp.dtype}x{sp.nbytes}B, codec "
                         f"has {seg}")
    return seg


def install_pages(layout: PageLayout, batch_leaves, pages, slots, *,
                  codec=None):
    """Scatter G staged pages into the batch cache leaves at ``slots``,
    in place; returns ``batch_leaves`` (tree-flatten order).

    ``pages`` takes every form ``_normalize_pages`` does.  A slot may
    repeat; the last page for it wins.  On CUDA the leaves of
    ``layout.kernel_groups()`` install in one kernel launch (one per
    chunk of ``install_tables``, for a layout or a G past one table);
    the rest
    (``fallback_indices()``: no slot axis, or an offset not aligned to
    the itemsize) install through the plain version on the same device,
    after it on the same stream.

    ``codec`` (a ``rmem.codec.PageCodec``) declares the staged pages
    codec-encoded (``codec.encoded_bytes`` wide).  They are decoded on
    their device into logical pages first (``PageCodec.decode_row``,
    plain PyTorch, as the reference's Pallas route decodes outside its
    kernel), then installed as above."""
    batch_leaves = list(batch_leaves)
    if len(batch_leaves) != len(layout.leaves):
        raise ValueError(f"{len(batch_leaves)} leaves != layout "
                         f"{len(layout.leaves)}")
    for sp, leaf in zip(layout.leaves, batch_leaves):
        _check_leaf(sp, leaf, sp.batch_shape)
    width = None
    if codec is not None:
        if codec.page_bytes != layout.page_bytes:
            raise ValueError(f"codec pages {codec.page_bytes}B != "
                             f"layout {layout.page_bytes}B")
        for sp in layout.leaves:
            _codec_seg(codec, sp)
        width = codec.encoded_bytes
    entries = _normalize_pages(layout, pages, width)
    slots = _check_slots(layout, slots, len(entries))
    dev = _device_of(batch_leaves + [b for b, _ in entries])
    if codec is not None:
        dec = codec.decode_row(torch.stack([b[r] for b, r in entries]))
        entries = [(dec, g) for g in range(dec.shape[0])]
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
