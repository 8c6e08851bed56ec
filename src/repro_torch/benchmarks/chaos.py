"""Chaos soak: serve under a seeded FaultPlan stays correct and bounded.

Twin of ``benchmarks/chaos.py``: the same cells and rows, through the
port's serve CLI entry point (``repro_torch.launch.serve.main``).  It
serves full-width qwen2-0.5b, bf16, weights from the seed; ``smoke``
(the CLI's ``--smoke``) reduces it with ``reduce_for_smoke``, as the
reference always does.  Every faulty cell is compared with its
same-topology fault-free baseline:

* **bit-exact** — every request the faulty run served produced exactly
  the baseline's tokens; faults may *shed* a request (typed, counted,
  ``Request.failed``) but never corrupt a survivor.  Replicated cells
  must also shed nothing and serve every request: checksums catch the
  injected bit-flip, and replica fallback with retry heals every
  transient.
* **bounded latency** — the faulty cell's TTFT p99 may inflate (retry
  backoff, replica failover, flap windows) by at most ``P99_BOUND_S``
  over its baseline (host wall time).
* **zero unhandled exceptions** — any crash propagates and fails the
  bench outright.

``ok`` is all cells bit-exact and bounded; the seed is recorded.

    python -m repro_torch.benchmarks.chaos [--quick|--smoke]
        [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import emit, write_bench_json
from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main

#: faulty cells may inflate TTFT p99 by at most this much over their
#: fault-free baseline — generous (the retry budget is 0.25 s an op,
#: flap windows add failover hops) but finite
P99_BOUND_S = 2.0


def _serve(path: str, shards: int, replicas: int, *, requests: int,
           max_new: int, device, smoke: bool, rate: float = 0.0,
           timeout_rate: float = 0.0, corrupt: float = 0.0,
           flap: str = "", fault_seed: int = 7) -> dict:
    argv = ["--requests", str(requests), "--slots", "2",
            "--max-new", str(max_new), "--prompt-len", "8",
            "--access-path", path, "--device", str(device)]
    if smoke:
        argv.append("--smoke")
    if shards > 1:
        argv += ["--kv-shards", str(shards),
                 "--kv-replicas", str(replicas)]
    if rate or timeout_rate or corrupt or flap:
        argv += ["--fault-seed", str(fault_seed),
                 "--fault-rate", str(rate),
                 "--fault-timeout-rate", str(timeout_rate)]
        if corrupt:
            argv += ["--fault-corrupt", str(corrupt)]
        if flap:
            argv += ["--fault-flap", flap]
    return serve_main(argv)


def run(quick: bool = False, out: str = "", device=None,
        smoke: bool = False) -> dict:
    dev = resolve_device(device)
    # cells: (label, path, shards, replicas, fault kwargs).  Replicated
    # cells get the full menu (errors, timeouts, one bit-flip, one node
    # flap) and must survive it all; unsharded cells get error and
    # timeout rates only (a flipped store has no replica to heal from)
    if quick:
        requests, max_new = 8, 8
        cells = [
            ("xdma_faults", "xdma", 1, 1,
             dict(rate=0.05, timeout_rate=0.02)),
            ("verbs_faults", "verbs", 1, 1,
             dict(rate=0.05, timeout_rate=0.02)),
            ("fabric_chaos", "xdma", 4, 2,
             dict(rate=0.05, timeout_rate=0.02, corrupt=0.2,
                  flap="5:25")),
        ]
    else:
        requests, max_new = 16, 12
        cells = [
            ("xdma_faults", "xdma", 1, 1,
             dict(rate=0.02, timeout_rate=0.01)),
            ("qdma_faults", "qdma", 1, 1,
             dict(rate=0.02, timeout_rate=0.01)),
            ("verbs_faults", "verbs", 1, 1,
             dict(rate=0.05, timeout_rate=0.02)),
            ("fabric_chaos", "xdma", 4, 2,
             dict(rate=0.02, timeout_rate=0.01, corrupt=0.2,
                  flap="5:25")),
            ("fabric_verbs_chaos", "verbs", 4, 2,
             dict(rate=0.05, timeout_rate=0.02, corrupt=0.2,
                  flap="5:25")),
        ]
    baselines: dict = {}
    rows = []
    for label, path, shards, replicas, faults in cells:
        topo = (path, shards, replicas)
        if topo not in baselines:
            baselines[topo] = _serve(path, shards, replicas,
                                     requests=requests, max_new=max_new,
                                     device=dev, smoke=smoke)
        base = baselines[topo]
        res = _serve(path, shards, replicas, requests=requests,
                     max_new=max_new, device=dev, smoke=smoke, **faults)
        survivors_exact = all(base["outputs"].get(rid) == toks
                              for rid, toks in res["outputs"].items())
        replicated = replicas > 1
        full_coverage = set(res["outputs"]) == set(base["outputs"])
        base_p99 = base["latency"]["ttft_s"]["p99"]
        fault_p99 = res["latency"]["ttft_s"]["p99"]
        bounded = fault_p99 <= base_p99 + P99_BOUND_S
        bit_exact = survivors_exact and (full_coverage or not replicated)
        ok = (bit_exact and bounded and res["undrained"] == 0 and
              (res["shed"] == 0 or not replicated))
        row = {"cell": label, "path": path, "shards": shards,
               "replicas": replicas, "faults": faults,
               "served": res["requests"], "shed": res["shed"],
               "bit_exact": bit_exact, "bounded": bounded,
               "base_ttft_p99_s": base_p99,
               "fault_ttft_p99_s": fault_p99,
               "p99_inflation_s": fault_p99 - base_p99,
               "plan": res["faults"]["plan"],
               "retry": res["faults"]["retry"], "ok": ok}
        rows.append(row)
        injected = sum(row["plan"][k] for k in
                       ("errors", "timeouts", "corruptions",
                        "flap_rejections"))
        emit(f"chaos_{label}", fault_p99 * 1e6,
             f"bit_exact={bit_exact} shed={res['shed']} "
             f"injected={injected} "
             f"retries={res['faults']['retry']['retries']} "
             f"p99_inflation={fault_p99 - base_p99:.3f}s ok={ok}")
    data = {"chaos": {
        "rows": rows,
        "p99_bound_s": P99_BOUND_S,
        "bit_exact": all(r["bit_exact"] for r in rows),
        "total_shed": sum(r["shed"] for r in rows),
        "total_injected": sum(
            sum(r["plan"][k] for k in ("errors", "timeouts",
                                       "corruptions", "flap_rejections"))
            for r in rows),
        "ok": all(r["ok"] for r in rows)}}
    emit("chaos_sweep_total", 0.0,
         f"injected={data['chaos']['total_injected']} "
         f"shed={data['chaos']['total_shed']} "
         f"ok={data['chaos']['ok']}")
    if out:
        write_bench_json(out, data)
    return data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="--quick with the reduced qwen2-0.5b")
    ap.add_argument("--json", default="",
                    help="write the sweep to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick or args.smoke, out=args.json,
               device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
