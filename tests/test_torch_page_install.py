"""Page pack and install of the port against the reference's Pallas
kernels (interpret mode), byte for byte, on the five cache families of
``tests/test_kernels.py`` plus one tree with a leaf that has no slot axis
and one whose offset is not aligned to its itemsize; and the pack
and install kernels' launch tables (struct layout against the CUDA
source, each byte written once, the served layouts in one launch, long
layouts and many pages split into counted launches), and the install
timer of ``benchmarks/install_host.py`` on the plain version."""
import bisect
import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import page_install as P  # noqa: E402
from repro_torch.rmem.codec import make_codec  # noqa: E402

FAMILIES = ["qwen2-0.5b", "rwkv6-1.6b", "qwen2-moe-a2.7b",
            "qwen2-vl-7b", "recurrentgemma-2b"]
CASES = FAMILIES + ["synthetic"]
BATCH = 3


def _synthetic(batch):
    """A "len" counter with no slot axis (merges by max) and a bf16 leaf
    at an odd byte offset (behind a 3-byte int8 leaf)."""
    return {"a_flags": np.zeros((batch, 3), np.int8),
            "b_kv": np.zeros((2, batch, 4, 8), ml_dtypes.bfloat16),
            "c_len": np.zeros((2,), np.int32)}


def _trees(case):
    if case == "synthetic":
        return _synthetic(1), _synthetic(BATCH)
    cfg = reduce_for_smoke(get_config(case))
    return (jax.tree.map(np.asarray, T.init_cache(cfg, 1, 32)),
            jax.tree.map(np.asarray, T.init_cache(cfg, BATCH, 32)))


def _randomize(tree, seed):
    """Random values of each leaf's own dtype (no NaN bit patterns, so the
    reference's bytes are the values' bytes)."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    out = []
    for l in leaves:
        if jnp.issubdtype(l.dtype, jnp.floating):
            out.append(rng.standard_normal(l.shape).astype(np.float32)
                       .astype(l.dtype))
        else:
            out.append(rng.integers(0, 100, l.shape).astype(l.dtype))
    return jax.tree.unflatten(treedef, out)


def _layouts(case):
    single, batch = _trees(case)
    ref = ops.page_layout(single, batch, BATCH)
    port = P.page_layout(interop.tree_to_torch(single),
                         interop.tree_to_torch(batch), BATCH)
    return single, batch, ref, port


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x).reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _ref_pages(single, ref, seeds):
    return np.stack([ops.pack_page_ref(
        ref, jax.tree.leaves(_randomize(single, s))) for s in seeds])


@pytest.mark.parametrize("case", CASES)
def test_page_layout_matches_reference(case):
    _, _, ref, port = _layouts(case)
    assert port.page_bytes == ref.page_bytes
    assert [(s.index, s.offset, s.shape, s.batch_shape, s.dtype,
             s.slot_axis) for s in port.leaves] == \
        [(s.index, s.offset, s.shape, s.batch_shape, s.dtype, s.slot_axis)
         for s in ref.leaves]
    assert port.fallback_indices() == ref.fallback_indices()
    assert {k: [s.index for s in v] for k, v in
            port.kernel_groups().items()} == \
        {k: [s.index for s in v] for k, v in ref.kernel_groups().items()}
    if case == "synthetic":
        assert ref.fallback_indices() == (1, 2)   # misaligned, no slot axis


@pytest.mark.parametrize("case", CASES)
def test_pack_page_matches_reference(case):
    single, _, ref, port = _layouts(case)
    leaves = jax.tree.leaves(_randomize(single, 11))
    want = np.asarray(ops.pack_page(ref, leaves, mode="pallas",
                                    interpret=True))
    np.testing.assert_array_equal(want, ops.pack_page_ref(ref, leaves))
    tleaves = [interop.to_torch(l) for l in leaves]
    np.testing.assert_array_equal(
        P.pack_page_torch(port, tleaves).numpy(), want)
    np.testing.assert_array_equal(P.pack_page(port, tleaves).numpy(), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["stacked", "entries"])
def test_install_pages_matches_reference(case, form):
    single, batch, ref, port = _layouts(case)
    flat_b = jax.tree.leaves(_randomize(batch, 5))
    pages = _ref_pages(single, ref, (20, 21, 22))
    slots = [2, 0, 1]
    want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                             jnp.asarray(pages), slots, mode="pallas",
                             interpret=True)
    tp = torch.from_numpy(pages)
    if form == "stacked":
        ref_pages, port_pages = jnp.asarray(pages), tp
    else:
        # the TieredStore handoff: a staged group of two (rows swapped)
        # plus one whole page
        ref_pages = [(jnp.asarray(pages[:2]), 1), (jnp.asarray(pages[:2]), 0),
                     (jnp.asarray(pages[2]), None)]
        port_pages = [(tp[:2], 1), (tp[:2], 0), (tp[2], None)]
        slots = [slots[1], slots[0], slots[2]]
        want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                                 ref_pages, slots, mode="pallas",
                                 interpret=True)
    for fn in (P.install_pages_torch, P.install_pages):
        got = fn(port, [interop.to_torch(b) for b in flat_b], port_pages,
                 slots)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))


@pytest.mark.parametrize("case", CASES)
def test_pack_install_round_trip(case):
    """Pack a slot's leaves, install the page into a zero batch at slot
    1: slot 1 of every slot-axis leaf holds the leaf, the rest stay 0,
    and a no-slot-axis leaf holds the max."""
    single, batch, _, port = _layouts(case)
    leaves = [interop.to_torch(l)
              for l in jax.tree.leaves(_randomize(single, 3))]
    zeros = [interop.to_torch(l) for l in jax.tree.leaves(batch)]
    got = P.install_pages(port, zeros, P.pack_page(port, leaves), [1])
    for sp, g, l in zip(port.leaves, got, leaves):
        if sp.slot_axis is None:
            assert torch.equal(g, torch.maximum(torch.zeros_like(l), l))
            continue
        assert torch.equal(g.narrow(sp.slot_axis, 1, 1), l)
        assert not g.narrow(sp.slot_axis, 0, 1).float().abs().sum()


def test_install_slot_matches_per_leaf_set():
    single, batch, ref, port = _layouts("recurrentgemma-2b")
    flat_b = jax.tree.leaves(_randomize(batch, 7))
    flat_o = jax.tree.leaves(_randomize(single, 8))
    want = ops.install_slot(ref, flat_b, flat_o, 2)
    got = P.install_slot(port, [interop.to_torch(b) for b in flat_b],
                         [interop.to_torch(o) for o in flat_o], 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_bad_arguments_raise():
    single, batch, ref, port = _layouts("qwen2-0.5b")
    leaves = [interop.to_torch(l) for l in jax.tree.leaves(single)]
    flat_b = [interop.to_torch(l) for l in jax.tree.leaves(batch)]
    page = P.pack_page(port, leaves)
    other = make_codec("int8", port.page_bytes + 4, dtype="float32")
    with pytest.raises(ValueError, match="codec pages"):
        P.install_pages(port, flat_b, page, [0], codec=other)
    with pytest.raises(ValueError, match="must lie in"):
        P.install_pages(port, flat_b, torch.stack([page, page]), [1, BATCH])
    with pytest.raises(ValueError, match="must lie in"):
        P.install_pages_torch(port, flat_b, page, [-1])
    with pytest.raises(ValueError, match="leaf 0"):
        P.pack_page(port, [leaves[0].float()] + leaves[1:])
    with pytest.raises(ValueError, match="bytes"):
        P.install_pages(port, flat_b, page[:-1], [0])


@pytest.mark.parametrize("case", ["qwen2-0.5b", "recurrentgemma-2b",
                                  "synthetic"])
def test_repeated_slots_last_page_wins(case):
    """An install whose slots repeat a slot gives the reference's bytes:
    pages go in order, so the last page for the slot wins."""
    single, batch, ref, port = _layouts(case)
    flat_b = jax.tree.leaves(_randomize(batch, 9))
    pages = _ref_pages(single, ref, (30, 31, 32, 33))
    slots = [1, 2, 1, 1]
    want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                             jnp.asarray(pages), slots, mode="pallas",
                             interpret=True)
    want_ref = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                                 jnp.asarray(pages), slots, mode="ref")
    last = P.install_pages(port, [interop.to_torch(b) for b in flat_b],
                           torch.from_numpy(pages[[1, 3]]), [2, 1])
    for fn in (P.install_pages_torch, P.install_pages):
        got = fn(port, [interop.to_torch(b) for b in flat_b],
                 torch.from_numpy(pages), slots)
        for g, w, r, l in zip(got, want, want_ref, last):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))
            np.testing.assert_array_equal(_bytes(g), _bytes(r))
            np.testing.assert_array_equal(_bytes(g), _bytes(l))
    assert P._last_per_slot(slots) == [1, 3]


def _nan_payload_pages(single, ref):
    """Two packed pages whose float leaves hold NaNs with non-canonical
    payloads (bf16 0x7fbe, f32 0x7fa00001) among finite values."""
    pages = _ref_pages(single, ref, (40, 41)).copy()
    for sp in ref.leaves:
        if sp.dtype not in ("bfloat16", "float32") or not sp.nbytes:
            continue
        width = 2 if sp.dtype == "bfloat16" else 4
        view = pages[:, sp.offset:sp.offset + sp.nbytes].view(
            np.uint16 if width == 2 else np.uint32)
        view[:, ::7] = 0x7fbe if width == 2 else 0x7fa00001
    return pages


@pytest.mark.parametrize("case", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_nan_payloads_are_kept_by_the_port(case):
    """The reference on the CPU rewrites a NaN's payload to the canonical
    NaN (0x7fc0 in bf16) in every mode; a DMA, and the port's install,
    moves the bits unchanged.  So: equal bytes wherever the reference's
    value is not NaN; where it is NaN, the port's value is NaN too, with
    the page's own bytes; and pack -> install is byte-exact."""
    single, batch, ref, port = _layouts(case)
    flat_b = jax.tree.leaves(_randomize(batch, 4))
    pages = _nan_payload_pages(single, ref)
    slots = [2, 0]
    want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                             jnp.asarray(pages), slots, mode="pallas",
                             interpret=True)
    tp = torch.from_numpy(pages)
    got = P.install_pages(port, [interop.to_torch(b) for b in flat_b], tp,
                          slots)
    n_nan = 0
    for sp, g, w in zip(port.leaves, got, want):
        gb, wb = _bytes(g), _bytes(w)
        if sp.dtype not in ("bfloat16", "float32"):
            np.testing.assert_array_equal(gb, wb)
            continue
        gv = g.float().numpy().reshape(-1)
        wv = np.asarray(w, np.float32).reshape(-1)
        nan = np.isnan(wv)
        n_nan += int(nan.sum())
        np.testing.assert_array_equal(np.isnan(gv), nan)
        isz = 2 if sp.dtype == "bfloat16" else 4
        keep = np.repeat(~nan, isz)
        np.testing.assert_array_equal(gb[keep], wb[keep])
        # where NaN, the port kept the page's payload, byte for byte
        for s, g_ in zip(slots, range(len(slots))):
            seg = pages[g_, sp.offset:sp.offset + sp.nbytes]
            np.testing.assert_array_equal(
                _bytes(g.narrow(sp.slot_axis, s, 1).contiguous()), seg)
    assert n_nan > 0
    # the reference canonicalises: its NaNs are not the page's payload
    k = next(i for i, sp in enumerate(port.leaves)
             if sp.dtype == "bfloat16" and sp.slot_axis is not None)
    wk = np.asarray(want[k]).view(np.uint16)
    assert set(np.unique(wk[np.isnan(np.asarray(want[k], np.float32))])) \
        == {0x7fc0}
    # the port's own round trip keeps every byte
    leaves = [P._segment(tp, 0, sp) for sp in port.leaves]
    np.testing.assert_array_equal(P.pack_page(port, leaves).numpy(),
                                  pages[0])
    zeros = [interop.to_torch(l) for l in jax.tree.leaves(batch)]
    back = P.install_pages(port, zeros, P.pack_page(port, leaves), [1])
    for sp, b, l in zip(port.leaves, back, leaves):
        if sp.slot_axis is not None:
            np.testing.assert_array_equal(
                _bytes(b.narrow(sp.slot_axis, 1, 1).contiguous()),
                _bytes(l))


# ---------------------------------------------------------------------------
# the pack kernel's launch tables (host side: no card needed)
# ---------------------------------------------------------------------------

CU = (pathlib.Path(P.__file__).resolve().parent.parent / "csrc" /
      "page_install.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\w+);", CU).group(1))


def test_pack_table_matches_the_source():
    assert (_cu_const("kThreads"), _cu_const("kPackUnroll"),
            _cu_const("kMaxPackLeaves")) == (P.PACK_THREADS, P.PACK_UNROLL,
                                             P.MAX_PACK_LEAVES)
    leaf = re.search(r"struct PackLeaf {(.*?)\n};", CU, re.S).group(1)
    assert re.findall(r"^\s*(long long|int) (\w+);", leaf, re.M) == [
        ("long long", "src"), ("long long", "page_offset"),
        ("long long", "nbytes"), ("int", "width"), ("int", "first_block")]
    assert [(n, ctypes.sizeof(t)) for n, t in P.PackLeaf._fields_] == [
        ("src", 8), ("page_offset", 8), ("nbytes", 8), ("width", 4),
        ("first_block", 4)]
    table = re.search(r"struct PackTable {(.*?)\n};", CU, re.S).group(1)
    assert re.findall(r"^\s*(\w+) (\w+(?:\[\w+\])?);", table, re.M) == [
        ("int", "n"), ("int", "blocks"), ("PackLeaf", "leaf[kMaxPackLeaves]")]
    assert ctypes.sizeof(P.PackLeaf) == 32
    assert P.PackTable.leaf.offset == 8
    # the table and the page pointer fit a launch's 4,096 bytes
    assert ctypes.sizeof(P.PackTable) == 8 + 32 * P.MAX_PACK_LEAVES
    assert ctypes.sizeof(P.PackTable) + 8 <= 4096


def _emulate_pack(tables, page_bytes, sources):
    """The kernel's index arithmetic in numpy: each block finds its leaf
    by a binary search over the running offsets, each thread copies
    ``PACK_UNROLL`` words ``PACK_THREADS`` apart.  Returns the page and
    how often each byte was written."""
    page = np.zeros(page_bytes, np.uint8)
    writes = np.zeros(page_bytes, np.int64)
    lane = np.arange(P.PACK_THREADS)
    for t in tables:
        firsts = [t.leaf[i].first_block for i in range(t.n)]
        for b in range(t.blocks):
            L = t.leaf[bisect.bisect_right(firsts, b) - 1]
            words = L.nbytes // L.width
            src = sources[L.src].reshape(-1, L.width)
            dst = page[L.page_offset:L.page_offset + L.nbytes] \
                .reshape(-1, L.width)
            for u in range(P.PACK_UNROLL):
                i = (b - L.first_block) * P.PACK_BLOCK_WORDS + \
                    u * P.PACK_THREADS + lane
                i = i[i < words]
                dst[i] = src[i]
                for w in range(L.width):
                    writes[L.page_offset + i * L.width + w] += 1
    return page, writes


@pytest.mark.parametrize("case", CASES)
def test_pack_tables_write_every_byte_once(case):
    """The launch tables, run through the kernel's index arithmetic,
    give the plain pack's page and write each byte exactly once."""
    single, _, _, port = _layouts(case)
    leaves = [interop.to_torch(l)
              for l in jax.tree.leaves(_randomize(single, 13))]
    page_ptr = 1 << 20
    tables = P.pack_tables(port, [l.data_ptr() for l in leaves], page_ptr)
    sources = {l.data_ptr(): _bytes(l) for l in leaves}
    page, writes = _emulate_pack(tables, port.page_bytes, sources)
    np.testing.assert_array_equal(page,
                                  P.pack_page_torch(port, leaves).numpy())
    assert (writes == 1).all()
    assert len(tables) == 1


@pytest.mark.parametrize("arch,max_len,n_leaves", [
    ("qwen2-0.5b", 128, 3), ("qwen2-0.5b", 2048, 3),
    ("recurrentgemma-2b", 2304, 11)])
def test_served_layouts_fit_one_launch(arch, max_len, n_leaves):
    """The full-width layouts that chip_smoke.py serves: their non-empty
    leaves fit one launch's table, in page order, and the table's blocks
    cover each leaf's words."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as PT
    cfg = get_config(arch)
    layout = P.page_layout(PT.init_cache(cfg, 1, max_len, "meta"),
                           PT.init_cache(cfg, 4, max_len, "meta"), 4)
    ptrs = [(1 << 30) + (i << 26) for i in range(len(layout.leaves))]
    (table,) = P.pack_tables(layout, ptrs, 1 << 34)
    assert table.n == n_leaves == sum(sp.nbytes > 0 for sp in layout.leaves)
    end, first = 0, 0
    for i in range(table.n):
        L = table.leaf[i]
        assert L.page_offset == end and L.first_block == first
        assert L.nbytes % L.width == 0
        end += L.nbytes
        first += -(-(L.nbytes // L.width) // P.PACK_BLOCK_WORDS)
    assert end == layout.page_bytes and table.blocks == first
    assert layout.page_bytes < 2 ** 31   # 32-bit indices


def test_layout_past_max_leaves_splits_into_launches():
    """250 leaves (some empty, some odd-sized) take three launches of at
    most ``MAX_PACK_LEAVES`` leaves; together they write the plain
    pack's page, every byte once."""
    rng = np.random.default_rng(3)
    dtypes = [np.float32, np.int8, ml_dtypes.bfloat16, np.int32]
    single, batch = {}, {}
    for i in range(250):
        dt = dtypes[i % 4]
        n = 0 if i % 37 == 5 else int(rng.integers(1, 300))
        single[f"l{i:03d}"] = (rng.standard_normal((1, n)) * 100) \
            .astype(np.float32).astype(dt)
        batch[f"l{i:03d}"] = np.zeros((2, n), dt)
    port = P.page_layout(interop.tree_to_torch(single),
                         interop.tree_to_torch(batch), 2)
    leaves = [interop.to_torch(l) for l in jax.tree.leaves(single)]
    tables = P.pack_tables(port, [l.data_ptr() for l in leaves], 1 << 20)
    n_live = sum(sp.nbytes > 0 for sp in port.leaves)
    assert [t.n for t in tables] == [120, 120, n_live - 240]
    assert all(t.leaf[0].first_block == 0 for t in tables)
    sources = {l.data_ptr(): _bytes(l) for l in leaves if l.numel()}
    page, writes = _emulate_pack(tables, port.page_bytes, sources)
    np.testing.assert_array_equal(page,
                                  P.pack_page_torch(port, leaves).numpy())
    assert (writes == 1).all()


# ---------------------------------------------------------------------------
# the install kernel's launch tables (host side: no card needed)
# ---------------------------------------------------------------------------

def test_install_table_matches_the_source():
    assert (_cu_const("kInstallUnroll"), _cu_const("kMaxInstallLeaves"),
            _cu_const("kMaxInstallPages")) == (
        P.INSTALL_UNROLL, P.MAX_INSTALL_LEAVES, P.MAX_INSTALL_PAGES)
    leaf = re.search(r"struct InstallLeaf {(.*?)\n};", CU, re.S).group(1)
    fields = [("long long", "dst"), ("long long", "page_offset"),
              ("long long", "inner"), ("int", "outer"), ("int", "width"),
              ("int", "row_blocks"), ("int", "rows_per_block"),
              ("int", "first_block"), ("int", "pad")]
    assert re.findall(r"^\s*(long long|int) (\w+);", leaf, re.M) == fields
    assert [(n, ctypes.sizeof(t)) for n, t in P.InstallLeaf._fields_] == [
        (n, 8 if t == "long long" else 4) for t, n in fields]
    page = re.search(r"struct InstallPage {(.*?)\n};", CU, re.S).group(1)
    assert re.findall(r"^\s*(long long|int) (\w+);", page, re.M) == [
        ("long long", "addr"), ("int", "slot"), ("int", "pad")]
    table = re.search(r"struct InstallTable {(.*?)\n};", CU, re.S).group(1)
    assert re.findall(r"^\s*(\w+) (\w+(?:\[\w+\])?);", table, re.M) == [
        ("int", "n_leaves"), ("int", "n_pages"), ("int", "page_blocks"),
        ("int", "batch"), ("InstallLeaf", "leaf[kMaxInstallLeaves]"),
        ("InstallPage", "page[kMaxInstallPages]")]
    assert re.search(r"static_assert\(sizeof\(InstallLeaf\) == 48", CU)
    assert re.search(r"static_assert\(sizeof\(InstallPage\) == 16", CU)
    assert re.search(r"static_assert\(sizeof\(InstallTable\) <= 4096", CU)
    assert ctypes.sizeof(P.InstallLeaf) == 48
    assert ctypes.sizeof(P.InstallPage) == 16
    assert P.InstallTable.leaf.offset == 16
    assert ctypes.sizeof(P.InstallTable) == \
        16 + 48 * P.MAX_INSTALL_LEAVES + 16 * P.MAX_INSTALL_PAGES <= 4096
    # the launch checks every leaf against the rule install_tables keeps
    launch = CU[CU.index('extern "C" int install_pages_launch'):]
    assert "row_words >= kInstallBlockWords" in launch
    assert "kInstallBlockWords / row_words" in launch


class _Memory:
    """Host buffers by address, for running a launch table on the CPU."""

    def __init__(self, tensors):
        self.bufs = [(t.data_ptr(), _bytes_view(t)) for t in tensors]

    def view(self, addr, nbytes):
        for base, buf in self.bufs:
            if base <= addr and addr + nbytes <= base + buf.size:
                return buf[addr - base:addr - base + nbytes]
        raise AssertionError(f"address {addr:#x}+{nbytes} is in no buffer")


def _bytes_view(t):
    return t.view(-1).view(torch.uint8).numpy()


def _emulate_install(table, mem, writes):
    """The install kernel's index arithmetic in numpy, block by block:
    page g = b // page_blocks, the leaf by a binary search over the
    first blocks, then a run inside one row or whole rows.  Adds one to
    ``writes`` (a dict of per-leaf counters by address) at every byte a
    block stores."""
    firsts = [table.leaf[i].first_block for i in range(table.n_leaves)]
    lane = np.arange(P.PACK_THREADS)
    B = table.batch
    for b in range(table.n_pages * table.page_blocks):
        g, r = divmod(b, table.page_blocks)
        L = table.leaf[bisect.bisect_right(firsts, r) - 1]
        pg = table.page[g]
        w, row_words = L.width, L.inner // L.width
        src = mem.view(pg.addr + L.page_offset, L.outer * L.inner) \
            .reshape(-1, w)
        dst = mem.view(L.dst, L.outer * B * L.inner).reshape(-1, w)
        lb = r - L.first_block
        i = np.concatenate([u * P.PACK_THREADS + lane
                            for u in range(P.INSTALL_UNROLL)])
        if L.row_blocks:
            o, c = divmod(lb, L.row_blocks)
            col = c * P.INSTALL_BLOCK_WORDS + i
            col = col[col < row_words]
            s_idx = o * row_words + col
            d_idx = (o * B + pg.slot) * row_words + col
        else:
            first = lb * L.rows_per_block
            rows = min(L.outer - first, L.rows_per_block)
            i = i[i < rows * row_words]
            q, col = np.divmod(i, row_words)
            s_idx = first * row_words + i
            d_idx = ((first + q) * B + pg.slot) * row_words + col
        assert len(np.unique(d_idx)) == len(d_idx)
        dst[d_idx] = src[s_idx]
        writes[L.dst].reshape(-1, w)[d_idx] += 1


def _ragged(batch):
    """Rows past one block (a ragged last run), rows of 8, 4 and 1-byte
    words, slot axes first, inner and last, more rows than one block
    holds, and pages of a 16-byte multiple (61,328 bytes), so each leaf
    keeps its own widest word."""
    return {"a": np.zeros((3, batch, 4100), np.float32),    # 1025 words
            "b": np.zeros((3000, batch), np.int32),         # 3 blocks
            "c": np.zeros((2, batch, 3, 2), np.float32),    # width 8
            "d": np.zeros((batch, 3, 5), ml_dtypes.bfloat16),
            "e": np.zeros((5, batch, 7), np.int8),          # width 1
            "f": np.zeros((batch, 15), np.int8)}


def _served(arch, max_len, batch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as PT
    cfg = get_config(arch)
    return (PT.init_cache(cfg, 1, max_len, "meta"),
            PT.init_cache(cfg, batch, max_len, "meta"))


def _random_bytes(t, rng):
    _bytes_view(t)[:] = rng.integers(0, 256, t.numel() * t.element_size(),
                                     dtype=np.uint8)
    return t


@pytest.mark.parametrize("case,B,G", [
    (("qwen2-0.5b", 128), 4, 4), (("recurrentgemma-2b", 2304), 2, 2),
    ("ragged", 3, 3)], ids=["qwen2-0.5b-128", "recurrentgemma-2b-2304",
                            "ragged"])
def test_install_tables_write_every_byte_once(case, B, G):
    """The launch tables, run through the kernel's index arithmetic over
    the real host buffers, give the plain install's bytes; every byte of
    each page's slot in every kernel leaf is written exactly once, and
    nothing else is."""
    if case == "ragged":
        single, batch = (interop.tree_to_torch(_ragged(1)),
                         interop.tree_to_torch(_ragged(B)))
    else:
        single, batch = _served(*case, B)
    layout = P.page_layout(single, batch, B)
    rng = np.random.default_rng(B + G)
    leaves = [_random_bytes(torch.empty(sp.batch_shape,
                                        dtype=interop.torch_dtype(sp.dtype)),
                            rng) for sp in layout.leaves]
    pages = _random_bytes(torch.empty((G, layout.page_bytes),
                                      dtype=torch.uint8), rng)
    slots = list(range(B))[::-1][:G]
    want = P.install_pages_torch(layout, [l.clone() for l in leaves],
                                 pages, slots)
    addrs = [pages.data_ptr() + g * layout.page_bytes for g in range(G)]
    tables, wide = P.install_tables(layout, [l.data_ptr() for l in leaves],
                                    addrs, slots)
    assert len(tables) == 1 and not wide
    mem = _Memory(leaves + [pages])
    writes = {l.data_ptr(): np.zeros(l.numel() * l.element_size(), np.uint8)
              for l in leaves}
    _emulate_install(tables[0], mem, writes)
    kernel = {sp.index for g in layout.kernel_groups().values() for sp in g}
    for sp, got, w in zip(layout.leaves, leaves, want):
        if sp.index not in kernel:
            continue
        np.testing.assert_array_equal(_bytes(got), _bytes(w))
        mark = np.zeros(sp.batch_shape, np.uint8)
        idx = [slice(None)] * len(sp.batch_shape)
        idx[sp.slot_axis] = slots
        mark[tuple(idx)] = 1
        cnt = writes[got.data_ptr()].reshape(-1, sp.itemsize)
        assert (cnt == mark.reshape(-1, 1)).all(), sp.index
    if case == "ragged":
        assert layout.page_bytes == 61328 and len(kernel) == 6
        assert [(L.row_blocks, L.rows_per_block, L.width)
                for L in tables[0].leaf[:tables[0].n_leaves]] == [
            (2, 0, 16), (0, 1024, 4), (0, 341, 8), (0, 34, 1),
            (0, 146, 1), (0, 68, 1)]


@pytest.mark.parametrize("arch,max_len,n_leaves", [
    ("qwen2-0.5b", 128, 3), ("qwen2-0.5b", 2048, 3),
    ("recurrentgemma-2b", 2304, 11)])
@pytest.mark.parametrize("B", [4, 128])
def test_served_layouts_install_in_one_launch(arch, max_len, n_leaves, B):
    """The layouts chip_smoke.py serves take one install launch for
    every G from 1 to the batch, with 32-bit indices, and the table's
    blocks cover every leaf's rows."""
    single, batch = _served(arch, max_len, B)
    layout = P.page_layout(single, batch, B)
    ptrs = [(1 << 36) + (i << 32) for i in range(len(layout.leaves))]
    for G in sorted({1, 2, B // 2, B}):
        addrs = [(1 << 44) + g * layout.page_bytes for g in range(G)]
        tables, wide = P.install_tables(layout, ptrs, addrs, range(G))
        assert len(tables) == 1 and not wide, G
        (t,) = tables
        assert (t.n_leaves, t.n_pages, t.batch) == (n_leaves, G, B)
        first = 0
        for i in range(t.n_leaves):
            L = t.leaf[i]
            assert L.first_block == first and L.inner % L.width == 0
            rb, rpb, nb = P.install_blocks(L.inner, L.outer, L.width)
            assert (L.row_blocks, L.rows_per_block) == (rb, rpb)
            # each row's words are covered once: runs of a row, or rows
            covered = (rb * P.INSTALL_BLOCK_WORDS if rb else
                       rpb * L.inner // L.width)
            assert covered >= L.inner // L.width
            first += nb
        assert t.page_blocks == first


def test_many_leaves_and_pages_split_into_counted_launches(monkeypatch):
    """40 leaves and 130 pages take 2 x 2 launches, each counted on
    ``install_pages.launches``; run through the kernel's arithmetic they
    give the plain install's bytes, each written once, and a slot that
    repeats keeps its last page."""
    rng = np.random.default_rng(5)
    B = 131
    single = {f"l{i:02d}": np.zeros((2, 1, 3 + i % 5), np.float32)
              for i in range(40)}
    batch = {k: np.zeros((2, B, v.shape[2]), np.float32)
             for k, v in single.items()}
    layout = P.page_layout(interop.tree_to_torch(single),
                           interop.tree_to_torch(batch), B)
    leaves = [_random_bytes(torch.empty(sp.batch_shape), rng)
              for sp in layout.leaves]
    pages = _random_bytes(torch.empty((131, layout.page_bytes),
                                      dtype=torch.uint8), rng)
    slots = list(range(130)) + [7]            # page 7 loses to page 130
    want = P.install_pages_torch(layout, [l.clone() for l in leaves],
                                 pages, slots)
    mem = _Memory(leaves + [pages])
    writes = {l.data_ptr(): np.zeros(l.numel() * 4, np.uint8)
              for l in leaves}
    launched = []

    class _Lib:
        @staticmethod
        def install_pages_launch(table_ref, wide, stream):
            launched.append(table_ref._obj)
            _emulate_install(table_ref._obj, mem, writes)
            return 0

    monkeypatch.setattr(P, "_kernels", lambda: _Lib)
    monkeypatch.setattr(P, "_stream_ptr", lambda dev: None)
    P.install_pages.launches = 0
    P._install_cuda(layout, leaves, [(pages, g) for g in range(131)],
                    slots, torch.device("cpu"))
    assert P.install_pages.launches == len(launched) == 4
    assert [(t.n_leaves, t.n_pages) for t in launched] == [
        (32, 128), (32, 2), (8, 128), (8, 2)]
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(_bytes(got), _bytes(w))
    for w in writes.values():
        cnt = w.reshape(2, B, -1)
        assert (cnt[:, :130] == 1).all() and (cnt[:, 130:] == 0).all()


def test_install_tables_refuse_repeated_slots():
    single, batch = _served("qwen2-0.5b", 128, 4)
    layout = P.page_layout(single, batch, 4)
    with pytest.raises(ValueError, match="distinct"):
        P.install_tables(layout, [1 << 36] * 3, [1 << 40, 1 << 41], [1, 1])


def test_install_host_timer_checks_and_times_the_plain_install(capsys):
    from repro_torch.benchmarks import install_host
    rows = install_host.main(["--device", "cpu", "--quick", "--rounds", "2"])
    assert [(r["arch"], r["max_len"]) for r in rows] == [("qwen2-0.5b", 128)]
    r = rows[0]
    assert r["launches_per_call"] == 0 and r["kernel_ms"] is None
    assert 0 < r["host_us_min"] <= r["host_us_per_call"] <= r["host_us_max"]
    assert "kernel_ms=not measured" in capsys.readouterr().out


def test_install_host_timer_refuses_a_second_checkout(tmp_path):
    from repro_torch.benchmarks import install_host
    with pytest.raises(SystemExit, match="already imported"):
        install_host.main(["--src", str(tmp_path), "--device", "cpu"])
