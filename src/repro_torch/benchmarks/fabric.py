"""Fabric sweep: shard scaling, replication cost, failover + rebalance.

Twin of ``benchmarks/fabric.py``, over verbs members with the same
4096-byte pages, doorbell depth 4 and 2 ms modelled per-doorbell link
RTT; each member's node hop lands on ``device`` (the card by default).
It measures what the sharded memory plane claims:

* **scaling** — a batched page workload over ``shards=N`` members splits
  into one doorbell-batched sub-op per member, all in flight at once, so
  aggregate throughput grows with N while ``shards=1`` stays within
  tolerance of the bare single path;
* **replication** — ``replicas=R`` multiplies write traffic by R while
  reads stay replica-routed;
* **failover + rebalance** — killing one of four members under R=2
  re-routes reads at once and the repair copies only the replicas the
  failure destroyed; adding a fifth member under R=1 moves about 1/5 of
  the pages.  Both record wall seconds and the moved fraction, and
  check every page bit-exact afterwards.

Rows take host wall time (every op waits on node threads).  ``ok`` is
the reference's gate, recorded: baseline parity (shards=1 within 3x of
the bare path), shards=4 >= shards=1 throughput, a moved fraction in
(0, 0.5], no page lost and bit-exact reads everywhere.

    python -m repro_torch.benchmarks.fabric [--quick|--smoke]
        [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.access.registry import create_path
from repro_torch.benchmarks.common import bench_seed, emit, write_bench_json
from repro_torch.device import resolve_device
from repro_torch.fabric import FabricManager

PAGE_BYTES = 4096
RTT_S = 0.002               # modelled per-doorbell link RTT (2 ms)
DOORBELL = 4


def _member_kw(n_pages, device):
    return dict(n_pages=n_pages, page_bytes=PAGE_BYTES, n_channels=1,
                n_nodes=1, doorbell_batch=DOORBELL, node_latency_s=RTT_S,
                device=device)


def _workload(path, n_pages, seed):
    """Batched write-all + read-all through ``path``; returns wall
    seconds per direction, whether the readback was bit-exact, and the
    values written."""
    rng = np.random.default_rng(seed)
    vals = [rng.integers(0, 256, PAGE_BYTES, np.uint8).astype(np.uint8)
            for _ in range(n_pages)]
    pages = list(range(n_pages))
    t0 = time.perf_counter()
    path.write_many_async(pages, vals).wait(120.0)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = path.read_many(pages)
    t_read = time.perf_counter() - t0
    exact = all(np.array_equal(out[i], vals[i]) for i in pages)
    return t_write, t_read, exact, vals


def run(quick: bool = False, out: str = "", device=None) -> dict:
    dev = resolve_device(device)
    seed = bench_seed()
    n_pages = 32 if quick else 64
    total_mb = n_pages * PAGE_BYTES / 1e6

    # -- bare single path: the baseline without the fabric --------------
    with create_path("verbs", **_member_kw(n_pages, dev)) as base:
        bw, br, bexact, _ = _workload(base, n_pages, seed)
    base_thr = 2 * total_mb / (bw + br)
    emit("fabric_baseline_verbs", (bw + br) * 1e6 / n_pages,
         f"thr={base_thr:.1f}MB/s bit_exact={bexact}")

    rows = []
    thr_by_shards = {}
    for shards, replicas in ((1, 1), (2, 1), (4, 1), (4, 2)):
        with create_path("fabric", member="verbs", shards=shards,
                         replicas=replicas,
                         **_member_kw(n_pages, dev)) as fab:
            w, r, exact, _ = _workload(fab, n_pages, seed)
        thr = 2 * total_mb / (w + r)
        if replicas == 1:
            thr_by_shards[shards] = thr
        rows.append({"shards": shards, "replicas": replicas,
                     "write_s": w, "read_s": r, "thr_mb_s": thr,
                     "bit_exact": exact})
        emit(f"fabric_s{shards}_r{replicas}", (w + r) * 1e6 / n_pages,
             f"thr={thr:.1f}MB/s write={w*1e3:.1f}ms read={r*1e3:.1f}ms "
             f"bit_exact={exact}")

    # -- failover: kill one of 4 members under R=2 -----------------------
    with create_path("fabric", member="verbs", shards=4, replicas=2,
                     **_member_kw(n_pages, dev)) as fab:
        _, _, _, vals = _workload(fab, n_pages, seed)
        mgr = FabricManager(fab)
        victim = fab.alive_members()[-1]
        t0 = time.perf_counter()
        repair = mgr.kill(victim)
        failover_s = time.perf_counter() - t0
        post = fab.read_many(list(range(n_pages)))
        failover_exact = all(np.array_equal(post[i], vals[i])
                             for i in range(n_pages))
        failover = {"victim": victim, "repair_s": failover_s,
                    "pages_recopied": repair["moved_pages"],
                    "lost": repair["lost"], "bit_exact": failover_exact}
    emit("fabric_failover_s4_r2", failover_s * 1e6,
         f"recopied={failover['pages_recopied']}/{n_pages} pages "
         f"bit_exact={failover_exact}")

    # -- rebalance: add one member to 4 under R=1 ------------------------
    with create_path("fabric", member="verbs", shards=4, replicas=1,
                     **_member_kw(n_pages, dev)) as fab:
        _, _, _, vals = _workload(fab, n_pages, seed)
        mgr = FabricManager(fab)
        new_member = create_path("verbs", **_member_kw(n_pages, dev))
        t0 = time.perf_counter()
        stats = mgr.rebalance(add=[new_member])
        rebalance_s = time.perf_counter() - t0
        post = fab.read_many(list(range(n_pages)))
        rebalance_exact = all(np.array_equal(post[i], vals[i])
                              for i in range(n_pages))
        rebalance = {"seconds": rebalance_s,
                     "moved_pages": stats["moved_pages"],
                     "moved_fraction": stats["moved_fraction"],
                     "bit_exact": rebalance_exact}
    emit("fabric_rebalance_4to5", rebalance_s * 1e6,
         f"moved={rebalance['moved_fraction']:.2f} of {n_pages} pages "
         f"(~1/5 expected) bit_exact={rebalance_exact}")

    shards1_ratio = thr_by_shards[1] / max(base_thr, 1e-9)
    ok_baseline = 1 / 3 <= shards1_ratio <= 3            # routing ~free
    ok_scaling = thr_by_shards[4] >= thr_by_shards[1]    # fan-out pays
    # consistent hashing: ~1/(N+1) = 0.2 expected; a full reshuffle (or
    # nothing at all) means placement is broken
    ok_rebalance = 0.0 < rebalance["moved_fraction"] <= 0.5
    bit_exact = (bexact and all(r["bit_exact"] for r in rows)
                 and failover_exact and rebalance_exact)
    data = {"fabric": {
        "rows": rows, "baseline_thr_mb_s": base_thr,
        "shards1_vs_baseline": shards1_ratio,
        "scaling_4_vs_1": thr_by_shards[4] / max(thr_by_shards[1], 1e-9),
        "failover": failover, "rebalance": rebalance,
        "bit_exact": bit_exact,
        "ok_baseline": ok_baseline, "ok_scaling": ok_scaling,
        "ok_rebalance": ok_rebalance,
        "ok": ok_baseline and ok_scaling and ok_rebalance and bit_exact
              and failover["lost"] == 0}}
    emit("fabric_sweep_total", 0.0,
         f"scaling={data['fabric']['scaling_4_vs_1']:.2f}x "
         f"baseline_ratio={shards1_ratio:.2f} ok={data['fabric']['ok']}")
    if out:
        write_bench_json(out, data)
    return data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="alias of --quick")
    ap.add_argument("--json", default="",
                    help="write the sweep to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick or args.smoke, out=args.json,
               device=args.device)


if __name__ == "__main__":
    main()
