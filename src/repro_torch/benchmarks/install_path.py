"""Install-path bench: the page kernels against the per-leaf chain, on the
card.

Twin of ``benchmarks/install_path.py``, at full-width qwen2-0.5b cache
layouts (``--smoke``: the ``reduce_for_smoke`` layouts the reference
uses), batch 8, max_len 64 (and 256 without ``--quick``):

* **install latency**: scatter G staged pages (G = 1, 2, 4, 8; 1 and 4
  with ``--quick``) into the batch cache through ``install_pages`` (the
  CUDA kernel of ``csrc/page_install.cu``), against ``ref_us``, the
  PyTorch counterpart of the reference's per-leaf chain: per page and
  leaf, slice the page, view it as the leaf's dtype and ``index_copy_``
  it at the slot.  The reference's 1.5x speedup gate at G >= 4 is
  recorded, not held.
* **spill pack**: ``pack_page`` against ``torch.cat`` of the leaves'
  byte views (``ref_us``); a packed spill crosses D2H once, the per-leaf
  chain once per leaf.
* **hop counts**, structural: a batched resident writeback group
  crosses H2C once (``TieredStore.update_pages``), the per-page loop
  once per page.
* **parity**: the kernels reproduce the plain versions' bytes, which
  are the reference's page format, exactly.

The reference's ``n_buffers`` axis (its Pallas kernel's DMA buffer
count) has no counterpart: the port's ``install_pages`` takes no buffer
count and no mode, so the rows drop it, as ``vmem_stream`` dropped
``modeled_tpu``.  Kernel and chain times are device time (CUDA events,
``time_call``) on the card and host time with ``--device cpu``, where
both sides are plain PyTorch.  On the card every timed call, kernel
and chain alike, takes the next of ``l2_rotation`` copies of its pages
and cache leaves, which together cover three times the L2, so a row
measures bytes from HBM, not a set that stays in L2 across calls (the
reference times one set).

    python -m repro_torch.benchmarks.install_path [--quick|--smoke]
        [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from repro_torch.benchmarks.common import (emit, l2_rotation, time_call,
                                           write_bench_json)
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.engine import MemoryEngine
from repro_torch.device import resolve_device
from repro_torch.interop import torch_dtype, tree_leaves
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.rmem import TieredStore

ARCH = "qwen2-0.5b"
BATCH = 8


def _randomize(tree, seed: int, dev):
    """The tree's leaves (tree-flatten order) refilled from ``seed`` as
    the reference fills them: float leaves from a float32 normal, integer
    leaves from [0, 100)."""
    rng = np.random.default_rng(seed)
    out = []
    for l in tree_leaves(tree):
        if l.dtype.is_floating_point:
            v = torch.from_numpy(rng.standard_normal(tuple(l.shape))
                                 .astype(np.float32))
        else:
            v = torch.from_numpy(rng.integers(0, 100, tuple(l.shape)))
        out.append(v.to(l.dtype).to(dev))
    return out


def _layout(max_len: int, smoke: bool):
    cfg = reduce_for_smoke(get_config(ARCH)) if smoke else get_config(ARCH)
    single = T.init_cache(cfg, 1, max_len, "meta")
    batch = T.init_cache(cfg, BATCH, max_len, "meta")
    return ops.page_layout(single, batch, BATCH), single, batch


def _chain_install(layout, leaves, pages, idx) -> None:
    """The per-leaf chain: per page and leaf, slice -> view ->
    ``index_copy_`` at the slot (``maximum`` for a leaf with no slot
    axis), in place."""
    for g in range(pages.shape[0]):
        for sp in layout.leaves:
            val = pages[g, sp.offset:sp.offset + sp.nbytes] \
                .view(torch_dtype(sp.dtype)).reshape(sp.shape)
            leaf = leaves[sp.index]
            if sp.slot_axis is None:
                torch.maximum(leaf, val, out=leaf)
            else:
                leaf.index_copy_(sp.slot_axis, idx[g], val)


def _rotation(dev, leaves, *tensors):
    """A callable giving the next of ``l2_rotation`` sets of
    ``(leaves, *tensors)``: the given set, then copies of it."""
    nbytes = sum(t.nbytes for t in leaves) + sum(t.nbytes for t in tensors)
    sets = [(leaves, *tensors)] + [
        ([l.clone() for l in leaves], *(t.clone() for t in tensors))
        for _ in range(l2_rotation(dev, nbytes) - 1)]
    return itertools.cycle(sets).__next__


def _bench_install(max_len: int, depths, dev, smoke: bool) -> list:
    layout, single, batch = _layout(max_len, smoke)
    flat_b = _randomize(batch, 1, dev)
    rows = []
    for G in depths:
        pages = torch.stack([ops.pack_page_ref(
            layout, _randomize(single, 10 + g, dev)) for g in range(G)])
        slots = list(range(G))
        idx = [torch.tensor([s], device=dev) for s in slots]
        nxt = _rotation(dev, flat_b, pages)
        ref_s = time_call(lambda: _chain_install(layout, *nxt(), idx),
                          repeats=5, warmup=1, calls=10, device=dev)
        fused_s = time_call(
            lambda: ops.install_pages(layout, *nxt(), slots),
            repeats=5, warmup=2, calls=10, device=dev)
        speedup = ref_s / fused_s if fused_s > 0 else float("inf")
        emit(f"install_fused[pb={layout.page_bytes},G={G}]",
             fused_s * 1e6,
             f"ref_us={ref_s*1e6:.1f};speedup={speedup:.2f}x")
        rows.append({"page_bytes": layout.page_bytes, "depth": G,
                     "ref_us": ref_s * 1e6, "fused_us": fused_s * 1e6,
                     "speedup": speedup})
    return rows


def _bench_spill(max_len: int, dev, smoke: bool) -> dict:
    layout, single, _ = _layout(max_len, smoke)
    leaves = _randomize(single, 3, dev)
    views = _rotation(dev, [l.reshape(-1).view(torch.uint8)
                            for l in leaves])
    ref_s = time_call(lambda: torch.cat(views()[0]), repeats=5, warmup=1,
                      calls=10, device=dev)
    nxt = _rotation(dev, leaves)
    fused_s = time_call(lambda: ops.pack_page(layout, nxt()[0]),
                        repeats=5, warmup=2, calls=10, device=dev)
    emit(f"spill_pack[pb={layout.page_bytes}]", fused_s * 1e6,
         f"ref_us={ref_s*1e6:.1f};d2h_fused=1;d2h_ref={len(leaves)}")
    return {"page_bytes": layout.page_bytes, "n_leaves": len(leaves),
            "ref_us": ref_s * 1e6, "fused_us": fused_s * 1e6,
            "d2h_hops_fused": 1, "d2h_hops_ref": len(leaves)}


def _bench_staged_h2c(dev, n_pages: int = 4) -> dict:
    """Resident-page writeback hops: the per-page loop vs one batched
    ``update_pages`` group (same bytes, one staged H2C)."""
    def hops(batched: bool) -> int:
        with TieredStore(n_pages, (64,), dtype="float32",
                         n_hot_slots=n_pages,
                         engine=MemoryEngine(n_channels=2,
                                             device=dev)) as st:
            for p in range(n_pages):
                st.write_page(p, np.full((64,), p, np.float32))
            st.ensure(list(range(n_pages)))
            updates = {p: np.full((64,), 90.0 + p, np.float32)
                       for p in range(n_pages)}
            if batched:
                st.update_pages(updates)
            else:
                for p, v in updates.items():
                    st.update_page(p, v)
            return st.stats()["staged_hops"]
    loop, batched = hops(False), hops(True)
    emit(f"staged_h2c[n={n_pages}]", 0.0,
         f"loop_hops={loop};batched_hops={batched}")
    return {"n_pages": n_pages, "loop_hops": loop,
            "batched_hops": batched}


def parity_inputs(max_len: int, dev, smoke: bool):
    """The parity check's layout, batch leaves (seed 4), single leaves
    (seed 5) and slots, as the reference draws them."""
    layout, single, batch = _layout(max_len, smoke)
    return (layout, _randomize(batch, 4, dev), _randomize(single, 5, dev),
            [3, 0])


def _check_parity(max_len: int, dev, smoke: bool) -> bool:
    layout, flat_b, leaves, slots = parity_inputs(max_len, dev, smoke)
    ref_page = ops.pack_page_ref(layout, leaves)
    if not torch.equal(ops.pack_page(layout, leaves).cpu(), ref_page.cpu()):
        return False
    pages = torch.stack([ref_page] * 2)
    want = ops.install_pages_ref(layout, [b.clone() for b in flat_b],
                                 pages, slots)
    got = ops.install_pages(layout, [b.clone() for b in flat_b], pages,
                            slots)
    return all(torch.equal(g.reshape(-1).view(torch.uint8).cpu(),
                           w.reshape(-1).view(torch.uint8).cpu())
               for g, w in zip(got, want))


def run(quick: bool = False, out: str = "", device=None,
        smoke: bool = False) -> dict:
    dev = resolve_device(device)
    max_lens = [64] if quick else [64, 256]
    depths = [1, 4] if quick else [1, 2, 4, 8]
    install_rows = []
    for ml in max_lens:
        install_rows += _bench_install(ml, depths, dev, smoke)
    spill = _bench_spill(max_lens[0], dev, smoke)
    staged = _bench_staged_h2c(dev)
    parity = _check_parity(max_lens[0], dev, smoke)
    emit("install_parity", 0.0, f"ok={parity}")
    deep = [r["speedup"] for r in install_rows if r["depth"] >= 4]
    payload = {
        "arch": ARCH, "batch_slots": BATCH,
        "install": install_rows, "spill": spill, "staged_h2c": staged,
        "gate": {
            "parity": parity,
            "depth4_speedup": max(deep) if deep else 0.0,
            "d2h_per_spill_fused": spill["d2h_hops_fused"],
            "d2h_per_spill_ref": spill["d2h_hops_ref"],
            "h2c_hops_batched": staged["batched_hops"],
            "h2c_hops_loop": staged["loop_hops"],
        }}
    if out:
        write_bench_json(out, payload)
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="--quick at the reduced qwen2-0.5b layouts")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick or args.smoke, out=args.json,
               device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
