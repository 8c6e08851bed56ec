"""Serving SLO bench: goodput against offered load, tails under admission
and mid-run kills.

Twin of ``benchmarks/serve_slo.py``: the same three scenarios, rows and
JSON keys, through the port's serve CLI fleet path
(``repro_torch.launch.serve.main``).  It serves full-width qwen2-0.5b,
bf16, weights from the run's seed; ``smoke`` (the CLI's ``--smoke``)
reduces it with ``reduce_for_smoke``, as the reference always does.

* **replica scaling** — the same burst of requests at 1 and 2 replicas;
  goodput is served tokens over fleet *virtual* seconds (the fleet clock
  charges ``max`` of the replicas' step wall times a round, modelling
  parallel hosts); ``ok_replicas`` holds when the second replica does
  not lower it.
* **SLO admission under saturation** — a burst deep enough that every
  request queues; the baseline admits FIFO until full, then the same
  burst runs with ``--slo-ttft-ms`` set from the baseline's own median
  queue wait.  ``ok_slo``: the policy sheds early (``failed`` starting
  ``slo``) and the requests it admitted keep a lower TTFT p99.
* **kill resilience** — 2 replicas over one sharded, replicated fabric;
  one fabric member fails (``--kv-kill-node``), then a whole replica is
  killed (``--kill-replica``) and its requests re-routed.  ``ok_kill``:
  every request both the kill run and the calm run served has the same
  tokens, requests were re-routed, and the TTFT p99 stayed finite.

Latencies and goodput are host wall time (a decode step reads its
tokens back, so it covers the card's work); ``ok_replicas`` and
``ok_slo`` are timing and policy ratios, ``kill_bit_exact`` is a bar.

    python -m repro_torch.benchmarks.serve_slo [--quick|--smoke]
        [--json PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import math

from repro_torch.benchmarks.common import (bench_seed, emit,
                                           write_bench_json)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main


def _serve(*, requests: int, slots: int, max_new: int, prompt_len: int,
           device, smoke: bool, replicas: int = 1,
           arrivals: str = "burst", tenants: int = 1,
           slo_ttft_ms: float = None, kv_shards: int = 1,
           kv_replicas: int = 1, kv_kill_node: int = None,
           kill_replica: int = None) -> dict:
    argv = ["--requests", str(requests),
            "--slots", str(slots), "--max-new", str(max_new),
            "--prompt-len", str(prompt_len),
            "--seed", str(bench_seed()),
            "--arrivals", arrivals, "--tenants", str(tenants),
            "--replicas", str(replicas), "--device", str(device)]
    if smoke:
        argv.append("--smoke")
    if slo_ttft_ms is not None:
        argv += ["--slo-ttft-ms", str(slo_ttft_ms)]
    if kv_shards > 1:
        argv += ["--kv-shards", str(kv_shards),
                 "--kv-replicas", str(kv_replicas)]
    if kv_kill_node is not None:
        argv += ["--kv-kill-node", str(kv_kill_node)]
    if kill_replica is not None:
        argv += ["--kill-replica", str(kill_replica)]
    return serve_main(argv)


def run(quick: bool = False, out: str = "", device=None,
        smoke: bool = False) -> dict:
    dev = resolve_device(device)
    n_scale = 8 if quick else 16
    n_sat = 12 if quick else 24
    n_kill = 8 if quick else 16
    max_new = 6 if quick else 10
    kw = dict(device=dev, smoke=smoke)

    # -- 1. goodput against replicas at a fixed offered load -------------
    # one discarded warm-up run over the largest request count first, so
    # the measured runs' fleet clocks see no first-use costs
    _serve(requests=max(n_scale, n_sat, n_kill), slots=2,
           max_new=max_new, prompt_len=4, replicas=1, tenants=2, **kw)
    rows = []
    goodput = {}
    for replicas in (1, 2):
        r = _serve(requests=n_scale, slots=2, max_new=max_new,
                   prompt_len=4, replicas=replicas, tenants=2, **kw)
        goodput[replicas] = r["goodput_tok_per_vs"]
        rows.append({"scenario": "scaling", "replicas": replicas,
                     "served": r["requests"], "tokens": r["tokens"],
                     "goodput_tok_per_vs": r["goodput_tok_per_vs"],
                     "virtual_seconds": r["fleet"]["virtual_seconds"],
                     "rounds": r["fleet"]["rounds"]})
        emit(f"serve_slo/scaling/replicas{replicas}",
             1e6 / max(r["goodput_tok_per_vs"], 1e-9),
             f"goodput={r['goodput_tok_per_vs']:.1f}tok/vs")
    scaling = goodput[2] / max(goodput[1], 1e-12)
    ok_replicas = goodput[2] > goodput[1]

    # -- 2. SLO admission under saturation -------------------------------
    base = _serve(requests=n_sat, slots=2, max_new=max_new,
                  prompt_len=6, tenants=2, **kw)
    # the deadline comes from the baseline's own median queue wait: about
    # the back half of the queue cannot make it
    slo_ms = max(base["latency"]["queue_wait_s"]["p50"] * 1e3, 1.0)
    pol = _serve(requests=n_sat, slots=2, max_new=max_new,
                 prompt_len=6, tenants=2, slo_ttft_ms=slo_ms, **kw)
    base_p99 = base["latency"]["ttft_s"]["p99"]
    pol_p99 = pol["latency"]["ttft_s"]["p99"]
    shed_slo = pol["rejected"]["reasons"].get("slo", 0)
    ok_slo = (shed_slo > 0 and pol["requests"] > 0 and
              pol_p99 < base_p99)
    for name, r in (("baseline", base), ("policy", pol)):
        rows.append({"scenario": "slo", "mode": name,
                     "slo_ms": None if name == "baseline" else slo_ms,
                     "served": r["requests"],
                     "shed_slo": r["rejected"]["reasons"].get("slo", 0),
                     "ttft_p50_s": r["latency"]["ttft_s"]["p50"],
                     "ttft_p99_s": r["latency"]["ttft_s"]["p99"],
                     "queue_wait_p99_s":
                         r["latency"]["queue_wait_s"]["p99"]})
        emit(f"serve_slo/slo/{name}",
             r["latency"]["ttft_s"]["p99"] * 1e6,
             f"served={r['requests']} "
             f"shed={r['rejected']['count']}")

    # -- 3. mid-run member kill + replica kill ---------------------------
    calm = _serve(requests=n_kill, slots=2, max_new=max_new,
                  prompt_len=6, replicas=2, tenants=2,
                  arrivals="poisson:100", kv_shards=3, kv_replicas=2,
                  **kw)
    kill = _serve(requests=n_kill, slots=2, max_new=max_new,
                  prompt_len=6, replicas=2, tenants=2,
                  arrivals="poisson:100", kv_shards=3, kv_replicas=2,
                  kv_kill_node=4, kill_replica=8, **kw)
    common_rids = set(calm["outputs"]) & set(kill["outputs"])
    bit_exact = all(calm["outputs"][k] == kill["outputs"][k]
                    for k in common_rids)
    kill_p99 = kill["latency"]["ttft_s"]["p99"]
    ok_kill = (bit_exact and len(common_rids) > 0 and
               kill["fleet"]["rerouted"] > 0 and
               kill["fabric"]["killed"] is not None and
               math.isfinite(kill_p99) and kill_p99 > 0.0)
    rows.append({"scenario": "kill",
                 "served_calm": calm["requests"],
                 "served_kill": kill["requests"],
                 "common": len(common_rids), "bit_exact": bit_exact,
                 "rerouted": kill["fleet"]["rerouted"],
                 "killed_member": kill["fabric"]["killed"],
                 "killed_replicas": kill["fleet"]["killed_replicas"],
                 "ttft_p99_s": kill_p99})
    emit("serve_slo/kill", kill_p99 * 1e6,
         f"bit_exact={bit_exact} rerouted={kill['fleet']['rerouted']}")

    doc = {"rows": rows,
           "goodput_1": goodput[1], "goodput_2": goodput[2],
           "scaling_2_vs_1": scaling, "ok_replicas": ok_replicas,
           "slo_ms": slo_ms, "shed_slo": shed_slo,
           "baseline_ttft_p99_s": base_p99,
           "policy_ttft_p99_s": pol_p99, "ok_slo": ok_slo,
           "kill_bit_exact": bit_exact,
           "kill_ttft_p99_s": kill_p99,
           "rerouted": kill["fleet"]["rerouted"], "ok_kill": ok_kill,
           "ok": ok_replicas and ok_slo and ok_kill}
    if out:
        write_bench_json(out, {"serve_slo": doc})
    return doc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="--quick with the reduced qwen2-0.5b")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="write BENCH_serve_slo.json here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    doc = run(quick=args.quick or args.smoke, out=args.json,
              device=args.device, smoke=args.smoke)
    print(f"# serve_slo: scaling {doc['scaling_2_vs_1']:.2f}x, "
          f"slo shed {doc['shed_slo']} "
          f"(p99 {doc['policy_ttft_p99_s']*1e3:.0f}ms vs baseline "
          f"{doc['baseline_ttft_p99_s']*1e3:.0f}ms), "
          f"kill bit_exact={doc['kill_bit_exact']} -> ok={doc['ok']}")
    return doc


if __name__ == "__main__":
    main()
