"""Serve CLI of the port: the single-engine closed-loop path.

Twin of the legacy path of ``repro/launch/serve.py``: the same flags
(those this slice ports), the same seeded prompts, and the same result
dict, ``outputs`` included.  Weights are initialised on the device from
``--seed`` with a ``torch.Generator`` (the reference's init rules, not
its numbers).  ``--device`` defaults to ``cuda``, which raises without a
card; ``--device cpu`` runs on the CPU.

    python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --max-new 16 [--kv-paging] \
        [--access-path xdma|qdma|verbs|auto] [--kv-node-latency S] \
        [--no-overlap] [--no-fused-install] [--kv-codec none|bf16|int8] \
        [--prefix-share] [--device cpu --smoke]

``--access-path``, ``--kv-codec`` and ``--prefix-share`` imply
``--kv-paging`` (over xdma unless a path is named); ``--kv-backend
local|remote`` is the deprecated spelling of xdma and verbs.  With
``--prefix-share`` every prompt opens with one seeded prefix of half its
length, drawn as the reference draws it, so the same seed gives the
reference's prompts.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np

from repro_torch import obs
from repro_torch.access import PathSelector
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (_KV_BACKEND_ALIAS, Request,
                                        ServeEngine, summarize_requests)

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
          f"h2c={kv['h2c_bytes']} c2h={kv['c2h_bytes']} "
          f"projected_cold={kv['cold_projected_seconds']*1e3:.2f}ms",
          flush=True)
    if kv.get("codec") or kv.get("shared_pages"):
        print(f"[serve:kv-capacity] codec={kv.get('codec')} "
              f"ratio={kv.get('compression_ratio', 1.0):.2f} "
              f"cold_logical={kv.get('cold_bytes_logical', 0)} "
              f"cold_physical={kv.get('cold_bytes_physical', 0)} "
              f"shared_pages={kv.get('shared_pages', 0)} "
              f"cow={kv.get('cow_copies', 0)}", flush=True)
    return kv


def draw_prompts(seed: int, n: int, prompt_len: int, vocab: int,
                 prefix_share: bool = False):
    """The CLI's seeded prompts, in the reference's draw order; returns
    ``(prompts, prefix_len)``.  With ``prefix_share`` every prompt opens
    with one seeded prefix of half its length (drawn first); off, the
    prompts are drawn exactly as without sharing."""
    rng = np.random.default_rng(seed)
    pfx_len = max(1, prompt_len // 2) if prefix_share else 0
    pfx = rng.integers(0, vocab, size=pfx_len).astype(np.int32) \
        if pfx_len else None
    prompts = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=prompt_len).astype(np.int32)
        if pfx is not None:
            prompt[:pfx_len] = pfx
        prompts.append(prompt)
    return prompts, pfx_len


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
    ap.add_argument("--access-path",
                    choices=["xdma", "qdma", "verbs", "auto"], default=None,
                    help="memory-access path for KV paging (implies "
                         "--kv-paging); 'auto' = model-driven PathSelector")
    ap.add_argument("--kv-backend", choices=["local", "remote"],
                    default=None,
                    help="DEPRECATED alias of --access-path "
                         "(local->xdma, remote->verbs)")
    ap.add_argument("--kv-doorbell", type=int, default=4,
                    help="doorbell batch depth for the verbs path")
    ap.add_argument("--kv-node-latency", type=float, default=0.0,
                    help="modeled far-memory link RTT in seconds, paid "
                         "once per doorbell on the verbs path")
    ap.add_argument("--no-overlap", action="store_true",
                    help="blocking admission: join every page fetch "
                         "before decoding")
    ap.add_argument("--fused-install", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="spill through pack_page and install through "
                         "install_pages (the CUDA kernels on the card); "
                         "--no-fused-install selects the per-leaf plain "
                         "PyTorch chain — output is bit-exact either way")
    ap.add_argument("--kv-codec", choices=["none", "bf16", "int8"],
                    default="none",
                    help="compress KV pages at the tier boundary "
                         "(implies --kv-paging): bf16 casts float32 "
                         "leaves (lossless on bf16 caches), int8 "
                         "quantizes float leaves per page; pages decode "
                         "on the device before the install")
    ap.add_argument("--prefix-share", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="dedup KV pages of requests sharing a prompt "
                         "prefix against one read-only base page "
                         "(copy-on-write deltas; implies --kv-paging); "
                         "output is bit-exact with sharing off")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without "
                         "a card; pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    access = args.access_path
    if args.kv_backend is not None:
        warnings.warn("--kv-backend is deprecated; use --access-path "
                      "{xdma,qdma,verbs,auto}", DeprecationWarning,
                      stacklevel=2)
        if access is None:
            access = _KV_BACKEND_ALIAS[args.kv_backend]
    paging = (args.kv_paging or access is not None or
              args.kv_codec != "none" or args.prefix_share)
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
                      kv_node_latency_s=args.kv_node_latency,
                      fused_install=args.fused_install,
                      kv_codec=args.kv_codec,
                      prefix_share=args.prefix_share, device=device)
    prompts, pfx_len = draw_prompts(args.seed, args.requests,
                                    args.prompt_len, cfg.vocab,
                                    args.prefix_share)
    t0 = time.time()
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new,
                           prefix_len=pfx_len))
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
        kv = _kv_stats_print(eng.pager, eng.access_path)
        sel = eng.pager.path
        if isinstance(sel, PathSelector):
            trace = sel.decisions
            placed = kv["cold"].get("placement", {})
            print(f"[serve:access-auto] {len(trace)} decisions, "
                  f"placement={placed}", flush=True)
            result["path_decisions"] = [
                {"op": d.op, "nbytes": d.nbytes, "batch": d.batch,
                 "direction": d.direction, "chosen": d.chosen,
                 "model_argmin": d.model_argmin} for d in trace]
        result["kv"] = kv
    eng.close()
    return result


if __name__ == "__main__":
    main()
