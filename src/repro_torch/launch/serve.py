"""Serve CLI of the port: the single-engine closed-loop path.

Twin of the legacy path of ``repro/launch/serve.py``: the same flags
(those this slice ports), the same seeded prompts, and the same result
dict, ``outputs`` included.  Weights are initialised on the device from
``--seed`` with a ``torch.Generator`` (the reference's init rules, not
its numbers).  ``--device`` defaults to ``cuda``, which raises without a
card; ``--device cpu`` runs on the CPU.

    python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --max-new 16 [--kv-paging] [--no-overlap] \
        [--no-fused-install] [--device cpu --smoke]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServeEngine, summarize_requests

__all__ = ["Request", "ServeEngine", "main"]


def _latency_summary(hists: dict, e2e_s) -> dict:
    e2e = obs.LogHistogram()
    for x in e2e_s:
        e2e.record(x)
    out = {name: h.summary() for name, h in hists.items()}
    out["e2e_s"] = e2e.summary()
    return out


def _kv_stats_print(pager, access_path) -> dict:
    kv = pager.stats()
    cold = kv["cold"]
    print(f"[serve:kv-paging] path={access_path} "
          f"tier={cold['tier']} "
          f"stored={cold['bytes_stored']} loaded={cold['bytes_loaded']} "
          f"h2c={kv['h2c_bytes']} "
          f"projected_cold={kv['cold_projected_seconds']*1e3:.2f}ms",
          flush=True)
    return kv


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-paging", action="store_true",
                    help="page each slot's prefill KV through a TieredStore")
    ap.add_argument("--access-path", choices=["xdma"], default=None,
                    help="memory-access path for KV paging (implies "
                         "--kv-paging)")
    ap.add_argument("--kv-doorbell", type=int, default=4,
                    help="doorbell batch depth (read by paths that "
                         "batch doorbells; xdma does not)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="blocking admission: join every page fetch "
                         "before decoding")
    ap.add_argument("--fused-install", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="spill through pack_page and install through "
                         "install_pages (the CUDA kernels on the card); "
                         "--no-fused-install selects the per-leaf plain "
                         "PyTorch chain — output is bit-exact either way")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without "
                         "a card; pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    access = args.access_path
    paging = args.kv_paging or access is not None
    if paging and access is None:
        access = "xdma"
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = T.tree_init(T.param_defs(cfg), cfg, args.seed, device)

    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_len=args.max_len,
                      access_path=access if paging else None,
                      kv_doorbell=args.kv_doorbell,
                      overlap=not args.no_overlap,
                      fused_install=args.fused_install, device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for r in range(args.requests):
        prompt = rng.integers(
            0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new))
    undrained = eng.run_until_drained()
    dt = time.time() - t0
    summ = summarize_requests(eng.done)
    served, toks = summ["served"], summ["tokens"]
    lat = summ["e2e_s"]
    print(f"[serve] {len(served)} requests "
          f"({summ['rejected']['count']} rejected), "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s), "
          f"p50 latency {np.median(lat):.2f}s", flush=True)
    lat_sum = _latency_summary(
        {"ttft_s": eng.ttft_hist, "tpot_s": eng.tpot_hist,
         "queue_wait_s": eng.queue_wait_hist}, lat)
    print(f"[serve:latency] ttft p50={lat_sum['ttft_s']['p50']*1e3:.1f}ms "
          f"p95={lat_sum['ttft_s']['p95']*1e3:.1f}ms "
          f"p99={lat_sum['ttft_s']['p99']*1e3:.1f}ms | "
          f"tpot p50={lat_sum['tpot_s']['p50']*1e3:.2f}ms "
          f"p99={lat_sum['tpot_s']['p99']*1e3:.2f}ms", flush=True)
    result = {"requests": len(served), "tokens": toks, "seconds": dt,
              "tok_per_s": toks / dt,
              "rejected": summ["rejected"],
              "shed": eng.shed_requests,
              "access_path": eng.access_path, "undrained": undrained,
              "overlap": eng.overlap,
              "overlap_installs": eng.overlap_installs,
              "blocking_installs": eng.blocking_installs,
              "install": {"fused": eng.install_fused,
                          "fallback": eng.install_fallback,
                          "hops_saved": eng.install_hops_saved},
              "latency": lat_sum,
              "outputs": {r.rid: list(r.out_tokens) for r in served}}
    if eng.pager is not None:
        result["kv"] = _kv_stats_print(eng.pager, eng.access_path)
    eng.close()
    return result


if __name__ == "__main__":
    main()
