"""Far-memory tier sweep: the paper's local-DMA vs RDMA contrast, on the
card.

Twin of ``benchmarks/far_memory.py``, with the same rows and JSON keys.
Sweeps transfer size x tier x doorbell-batch depth:

* ``local``: host DRAM through the XDMA-style ``MemoryEngine`` (an H2C
  and a C2H round trip, checked byte for byte once), beside the
  ``h100_host_path`` model (``host_model``);
* ``remote``: a ``MemoryNode`` through one-sided verbs at doorbell
  batches 1, 4 and 16 (1 and 4 with ``--quick``), beside the far-memory
  (RDMA) model with the per-doorbell setup amortized across the batch.

Plus the *miss-pipeline* sweep: ``TieredStore`` cold misses fetched one
page at a time (serial) against the batched pipeline and against
prefetch, and evictions at dirty ratios 0, 0.5 and 1 (clean pages move
zero cold bytes, dirty ones exactly their pages' bytes).  ``run(out=)``
writes the miss-pipeline metrics as JSON.

Plus the *path-selection* sweep: every (transfer size x batch) bucket
runs pinned through xdma, qdma and verbs and through the ``auto``
selector; rows record measured seconds, each path's projection, the
selector's choice and whether it matched the model argmin
(``run(select_out=)``).  With either JSON, ``_serve_metrics`` serves
through the serve CLI's ``main``, as the reference does: full-width
qwen2-0.5b (reduced by ``reduce_for_smoke`` only with ``smoke``) over
every access path, each checked to give the verbs run's tokens.

Every call here waits on the host (DMA, verbs, store, serve), so every
time is host wall time, never CUDA events.

    python -m repro_torch.benchmarks.far_memory [--quick] [--smoke]
        [--json PATH] [--select-json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.access import create_path
from repro_torch.benchmarks.common import (bench_seed, emit, time_call,
                                           write_bench_json)
from repro_torch.core.analytical import (bandwidth_gbps,
                                         doorbell_bandwidth_gbps,
                                         far_memory_path, h100_host_path)
from repro_torch.core.channels import Direction
from repro_torch.core.engine import MemoryEngine
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_cli
from repro_torch.rmem import (MemoryNode, MemoryRegion, QueuePair,
                              TieredStore, make_backend)

PATH_NAMES = ("xdma", "qdma", "verbs")
DIRTY_PAGE_BYTES = 1 << 14


def _local_rows(sizes, dev) -> None:
    with MemoryEngine(n_channels=2, device=dev) as eng:
        for size in sizes:
            x = np.ones(size // 4, np.float32)

            def rt():
                d = eng.write(x).wait()
                return eng.read(d).wait()
            if not np.array_equal(rt(), x):
                raise AssertionError(f"local {size}B: round trip differs")
            t = time_call(rt, repeats=3)
            proj = bandwidth_gbps(h100_host_path(), size, 2, Direction.C2H)
            emit(f"farmem_local_{size >> 10}KB", t * 1e6,
                 f"meas={2 * size / t / 1e9:.2f}GB/s "
                 f"host_model={proj:.1f}GB/s")


def _remote_rows(sizes, batches, dev) -> None:
    for size in sizes:
        for batch in batches:
            with MemoryNode("bench", size * batch + 4096, device=dev) as node:
                mr = MemoryRegion(np.arange(size * batch, dtype=np.uint64)
                                  .astype(np.uint8))
                qp = QueuePair(node, doorbell_batch=batch)
                base = node.alloc(size * batch)

                def burst():
                    for i in range(batch):
                        qp.post_write(mr, i * size, base + i * size, size)
                    qp.flush()
                burst()
                if not np.array_equal(
                        node.pool[base:base + size * batch], mr.buf):
                    raise AssertionError(f"remote {size}B x {batch}: the "
                                         f"node holds other bytes")
                t = time_call(burst, repeats=3)
                per_wr = t / batch
                proj = doorbell_bandwidth_gbps(far_memory_path(), size, batch)
                emit(f"farmem_remote_{size >> 10}KB_db{batch}", per_wr * 1e6,
                     f"meas={size / per_wr / 1e9:.2f}GB/s "
                     f"rmem_model={proj:.1f}GB/s "
                     f"wrs={qp.wrs_posted} compl={qp.cq.n_completions}")
                qp.close()


def _make_store(kind: str, n_pages: int, page_bytes: int, n_hot: int,
                depth: int, dev) -> TieredStore:
    kw = dict(n_nodes=1, doorbell_batch=depth, device=dev) \
        if kind == "remote" else {}
    return TieredStore(n_pages, (page_bytes,), dtype="uint8",
                       n_hot_slots=n_hot,
                       engine=MemoryEngine(n_channels=2, device=dev),
                       backend=make_backend(kind, n_pages, page_bytes, **kw))


def _miss_rows(quick: bool, dev) -> dict:
    """Miss-path sweep: serial per-page fetch vs the batched pipeline."""
    page_bytes = 1 << 15 if quick else 1 << 16
    n_miss = 8 if quick else 16
    depths = [1, 4] if quick else [1, 4, 8]
    out: dict = {"page_bytes": page_bytes, "n_miss": n_miss, "rows": []}
    for kind in ("local", "remote"):
        for depth in (depths if kind == "remote" else [n_miss]):
            with _make_store(kind, 2 * n_miss, page_bytes, n_miss,
                             depth, dev) as st:
                for p in range(2 * n_miss):
                    st.write_page(p, np.full(page_bytes, p % 251, np.uint8))
                miss = list(range(n_miss))

                def drop():
                    for p in miss:
                        st.release(p, writeback=False)

                def serial():
                    for p in miss:       # one miss, one fetch, at a time
                        st.ensure([p])
                    drop()

                def pipelined():
                    st.ensure(miss)      # batched loads + overlapped H2C
                    drop()

                def prefetched():
                    st.prefetch(miss)    # fetch starts before the demand
                    st.ensure(miss)
                    drop()

                # interleave the variants' repeats so drift in the host's
                # load cancels out of the speedup ratio
                serial(), pipelined(), prefetched()     # warmup
                samples = ([], [], [])
                for _ in range(5):
                    for fn, acc in zip((serial, pipelined, prefetched),
                                       samples):
                        t0 = time.perf_counter()
                        fn()
                        acc.append(time.perf_counter() - t0)
                t_ser, t_pipe, t_pre = (float(np.median(a))
                                        for a in samples)
                speedup = t_ser / t_pipe
                proj = doorbell_bandwidth_gbps(
                    far_memory_path() if kind == "remote" else
                    h100_host_path(), page_bytes, depth)
                tag = f"miss_{kind}_db{depth}"
                emit(f"{tag}_serial", t_ser / n_miss * 1e6,
                     f"meas={n_miss * page_bytes / t_ser / 1e9:.2f}GB/s")
                emit(f"{tag}_pipelined", t_pipe / n_miss * 1e6,
                     f"meas={n_miss * page_bytes / t_pipe / 1e9:.2f}GB/s "
                     f"speedup={speedup:.2f}x model={proj:.1f}GB/s")
                emit(f"{tag}_prefetched", t_pre / n_miss * 1e6,
                     f"speedup={t_ser / t_pre:.2f}x")
                out["rows"].append({
                    "backend": kind, "doorbell": depth,
                    "serial_s": t_ser, "pipelined_s": t_pipe,
                    "prefetched_s": t_pre, "speedup": speedup,
                    "projected_gbps": proj,
                    "bytes_moved": st.stats()["cold_bytes_moved"]})
    return out


def _dirty_rows(quick: bool, dev) -> list:
    """Eviction sweep over dirty ratio: clean pages move zero cold bytes."""
    page_bytes = DIRTY_PAGE_BYTES
    n_hot = 4 if quick else 8
    rows = []
    for kind in ("local", "remote"):
        for ratio in (0.0, 0.5, 1.0):
            with _make_store(kind, 2 * n_hot, page_bytes, n_hot, 4,
                             dev) as st:
                for p in range(2 * n_hot):
                    st.write_page(p, np.full(page_bytes, p % 251, np.uint8))
                st.ensure(list(range(n_hot)))
                n_dirty = int(round(ratio * n_hot))
                for p in range(n_dirty):
                    st.mark_dirty(p)
                stored0 = st.backend.stats()["bytes_stored"]
                c2h0 = st.c2h_bytes
                t = time_call(
                    lambda: st.ensure(list(range(n_hot, 2 * n_hot))),
                    repeats=1, warmup=0)    # one eviction wave
                s = st.stats()
                wb = st.backend.stats()["bytes_stored"] - stored0
                emit(f"evict_{kind}_dirty{int(ratio * 100)}",
                     t / n_hot * 1e6,
                     f"writeback={wb}B c2h={st.c2h_bytes - c2h0}B "
                     f"skipped={s['writeback_bytes_skipped']}B")
                rows.append({
                    "backend": kind, "dirty_ratio": ratio,
                    "evictions": s["evictions"],
                    "clean_evictions": s["clean_evictions"],
                    "writeback_bytes": wb,
                    "c2h_bytes": st.c2h_bytes - c2h0,
                    "writeback_bytes_skipped":
                        s["writeback_bytes_skipped"]})
    return rows


def _path_select_rows(quick: bool, dev) -> dict:
    """Auto-vs-pinned sweep: per (size x batch) bucket, run the same
    batched write+read volume pinned through each access path and through
    the ``auto`` selector, then audit the selector's recorded choice
    against the analytical-model argmin (idle paths, so occupancy is
    zero and the two must coincide)."""
    sizes = [1 << 12, 1 << 18] if quick else [1 << 12, 1 << 16, 1 << 20]
    batches = [1, 8]
    rows = []
    for size in sizes:
        for batch in batches:
            db = min(batch, 8)

            def mk(name):
                return create_path(name, n_pages=batch, page_bytes=size,
                                   n_channels=2, n_nodes=1,
                                   doorbell_batch=db, device=dev)

            vals = [np.full(size, (7 * i) % 251, np.uint8)
                    for i in range(batch)]
            want = np.stack(vals)
            pages = list(range(batch))
            pinned = {}
            for name in PATH_NAMES:
                with mk(name) as p:

                    def rt(p=p):
                        p.write_many(pages, vals)
                        return p.read_many(pages)
                    if not np.array_equal(rt(), want):
                        raise AssertionError(f"pathsel {name} {size}B x "
                                             f"{batch}: read differs")
                    t = time_call(rt, repeats=3)
                    pinned[name] = {
                        "seconds": t,
                        "projected_s": p.capabilities().projected_seconds(
                            size, batch, Direction.H2C) * batch}
            with mk("auto") as sel:

                def rt_auto():
                    sel.write_many(pages, vals)
                    return sel.read_many(pages)
                if not np.array_equal(rt_auto(), want):
                    raise AssertionError(f"pathsel auto {size}B x {batch}: "
                                         f"read differs")
                t_auto = time_call(rt_auto, repeats=3)
                chosen = sel.decisions[-1].chosen
            argmin = min(pinned, key=lambda n: pinned[n]["projected_s"])
            best_meas = min(p["seconds"] for p in pinned.values())
            row = {"size_bytes": size, "batch": batch,
                   "chosen": chosen, "model_argmin": argmin,
                   "matches_model": chosen == argmin,
                   "auto_seconds": t_auto,
                   "auto_projected_s": pinned[chosen]["projected_s"],
                   "auto_vs_chosen_pinned":
                       t_auto / pinned[chosen]["seconds"],
                   "auto_vs_best_pinned": t_auto / best_meas,
                   "pinned": pinned}
            rows.append(row)
            emit(f"pathsel_{size >> 10}KB_b{batch}", t_auto * 1e6,
                 f"chosen={chosen} model_argmin={argmin} "
                 f"auto_vs_chosen={t_auto / pinned[chosen]['seconds']:.2f}x "
                 f"auto_vs_best={t_auto / best_meas:.2f}x")
    all_match = all(r["matches_model"] for r in rows)
    emit("pathsel_summary", 0.0,
         f"buckets={len(rows)} all_match_model={all_match}")
    return {"rows": rows, "all_match_model": all_match}


def _serve_path(name: str, n_req: int, max_new: int, dev,
                smoke: bool = False):
    """One paged serve over access path ``name`` through the serve CLI's
    ``main`` (2 slots, the CLI's other defaults; the reduced model only
    with ``smoke``); returns the row and the outputs."""
    argv = ["--requests", str(n_req), "--max-new", str(max_new),
            "--slots", "2", "--seed", str(bench_seed()),
            "--access-path", name, "--device", str(dev)]
    res = serve_cli.main(argv + (["--smoke"] if smoke else []))
    kv = res.get("kv", {})
    row = {"tok_per_s": res["tok_per_s"],
           "requests": res["requests"],
           "h2c_bytes": kv.get("h2c_bytes", 0),
           "c2h_bytes": kv.get("c2h_bytes", 0),
           "cold_bytes_moved": kv.get("cold_bytes_moved", 0),
           "prefetch_hits": kv.get("prefetch_hits", 0)}
    return row, res["outputs"]


def _serve_metrics(quick: bool, dev, smoke: bool = False) -> dict:
    """Serve runs across access paths: tok/s + per-tier bytes, and the
    bit-exactness of every path against verbs."""
    n_req, max_new = (4, 8) if quick else (8, 16)
    per_path = {}
    outputs = {}
    for name in PATH_NAMES + ("auto",):
        per_path[name], outputs[name] = _serve_path(name, n_req, max_new,
                                                    dev, smoke)
    ref = outputs["verbs"]
    per_path["auto_bit_exact"] = all(o == ref for o in outputs.values())
    return per_path


def run(quick: bool = False, out: str = "", select_out: str = "",
        device=None, smoke: bool = False) -> dict:
    dev = resolve_device(device)
    sizes = [1 << 16, 1 << 20] if quick else [1 << 16, 1 << 18, 1 << 20,
                                              1 << 22]
    batches = [1, 4] if quick else [1, 4, 16]
    _local_rows(sizes, dev)
    _remote_rows(sizes, batches, dev)
    metrics = {"miss_pipeline": _miss_rows(quick, dev),
               "dirty_sweep": _dirty_rows(quick, dev)}
    if out or select_out:
        metrics["path_select"] = _path_select_rows(quick, dev)
        metrics["serve"] = _serve_metrics(quick, dev, smoke)
    if out:
        write_bench_json(out, metrics)
    if select_out:
        write_bench_json(select_out,
                         {"path_select": metrics["path_select"],
                          "serve": metrics["serve"]})
    return metrics


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced qwen2-0.5b (reduce_for_smoke)")
    ap.add_argument("--json", default="",
                    help="write miss-pipeline metrics JSON here")
    ap.add_argument("--select-json", default="",
                    help="write the auto-vs-pinned path-selection sweep "
                         "JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick, out=args.json, select_out=args.select_json,
               device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
