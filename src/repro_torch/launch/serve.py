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
        [--prefix-share] \
        [--kv-shards 4 --kv-replicas 2 --kv-kill-node 5] \
        [--fault-seed 7 --fault-rate 0.05 --fault-corrupt 0.2 \
         --fault-flap 2:12] [--trace-out T.json] [--metrics] \
        [--device cpu --smoke]

``--access-path``, ``--kv-codec``, ``--prefix-share``, ``--kv-shards``
and every ``--fault-*`` flag imply ``--kv-paging`` (over xdma unless a
path is named); ``--kv-backend local|remote`` is the deprecated spelling
of xdma and verbs, ``--kv-nodes`` that of ``--kv-shards``.  The fault
flags install a seeded ``FaultPlan`` for the run (its draws keyed by
each memory node's or host backend's fault scope) with a ``RetryPolicy``
and page checksums; ``--fault-flap LO:HI`` takes the last scope of the
path tree down for its ops LO to HI.  The result then holds ``faults``;
a sharded run holds ``fabric``; ``--metrics`` embeds the registry
snapshot as ``metrics`` and ``--trace-out`` writes a Chrome trace.  The
fleet frontend (``--arrivals``, ``--replicas``, ...) is ROADMAP A.4.  With
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
from repro_torch.faults import injector as _faults
from repro_torch.faults.injector import FaultPlan
from repro_torch.faults.retry import RetryPolicy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (_KV_BACKEND_ALIAS, Request,
                                        ServeEngine, summarize_requests)

__all__ = ["Request", "ServeEngine", "main"]


def _fault_scopes(path) -> list:
    """Scope ids a FaultPlan flap can name, in path order.  Walks the
    path tree: ShardedPath members, PathSelector legs, then each leaf's
    backend (LocalHostBackend) or far-memory nodes (RemoteBackend)."""
    members = getattr(path, "_members", None)
    if members is not None:                   # ShardedPath
        return [s for m in members.values() for s in _fault_scopes(m)]
    sub = getattr(path, "paths", None)
    if sub is not None:                       # PathSelector
        return [s for p in sub for s in _fault_scopes(p)]
    be = getattr(path, "backend", None)
    if be is None:
        return []
    fs = getattr(be, "fault_scope", None)
    if fs is not None:                        # LocalHostBackend
        return [fs]
    amap = getattr(be, "amap", None)
    if amap is not None:                      # RemoteBackend -> its nodes
        return list(dict.fromkeys(
            e.node.fault_scope for e in amap.entries))
    return []


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
    ap.add_argument("--kv-shards", type=int, default=1,
                    help="fabric members sharding the KV memory plane "
                         "(>1 builds a consistent-hash ShardedPath of "
                         "--access-path members)")
    ap.add_argument("--kv-replicas", type=int, default=1,
                    help="replication factor across fabric members")
    ap.add_argument("--kv-kill-node", type=int, default=None,
                    metavar="STEP",
                    help="fail one fabric member at this decode step "
                         "(fault injection; requires --kv-replicas >= 2)")
    ap.add_argument("--kv-nodes", type=int, default=None,
                    help="DEPRECATED alias of --kv-shards")
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
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="install a deterministic FaultPlan with this "
                         "seed (implies --kv-paging; same seed + "
                         "topology replays the same fault schedule)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-op probability of an injected transient "
                         "completion error on the memory plane")
    ap.add_argument("--fault-timeout-rate", type=float, default=0.0,
                    help="per-op probability of an injected completion "
                         "timeout")
    ap.add_argument("--fault-corrupt", type=float, default=0.0,
                    help="per-op probability of a payload bit-flip "
                         "(capped at one flip per run; checksums catch "
                         "it and replicas heal it when sharded)")
    ap.add_argument("--fault-flap", default=None, metavar="LO:HI",
                    help="flap one memory node/backend: its ops in "
                         "[LO, HI) fail NodeUnavailable (down), then it "
                         "serves again (up); pair with --kv-replicas 2 "
                         "so reads fail over meanwhile")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing and write a Chrome trace-event "
                         "JSON here (loadable in Perfetto)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable live metrics and embed a registry "
                         "snapshot in the result dict")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises without "
                         "a card; pass cpu to run on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace_out:
        obs.trace.enable()
    if args.metrics:
        obs.metrics.enable_live()
    access = args.access_path
    if args.kv_backend is not None:
        warnings.warn("--kv-backend is deprecated; use --access-path "
                      "{xdma,qdma,verbs,auto}", DeprecationWarning,
                      stacklevel=2)
        if access is None:
            access = _KV_BACKEND_ALIAS[args.kv_backend]
    kv_shards = args.kv_shards
    if args.kv_nodes is not None:
        warnings.warn("--kv-nodes is deprecated; use --kv-shards "
                      "(fabric membership)", DeprecationWarning,
                      stacklevel=2)
        if kv_shards == 1:
            kv_shards = args.kv_nodes
    faults_on = (args.fault_seed is not None or args.fault_rate > 0 or
                 args.fault_timeout_rate > 0 or args.fault_corrupt > 0 or
                 args.fault_flap is not None)
    fault_seed = args.fault_seed if args.fault_seed is not None \
        else args.seed
    # faults imply paging: the plan injects into the memory plane, so a
    # chaos run without one would test nothing
    paging = (args.kv_paging or access is not None or kv_shards > 1 or
              faults_on or args.kv_codec != "none" or args.prefix_share)
    if paging and access is None:
        access = "xdma"
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = T.tree_init(T.param_defs(cfg), cfg, args.seed, device)
    retry_policy = RetryPolicy(seed=fault_seed) if faults_on else None

    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_len=args.max_len,
                      access_path=access if paging else None,
                      kv_shards=kv_shards, kv_replicas=args.kv_replicas,
                      kv_kill_step=args.kv_kill_node,
                      kv_doorbell=args.kv_doorbell,
                      overlap=not args.no_overlap,
                      kv_node_latency_s=args.kv_node_latency,
                      kv_retry=retry_policy, kv_integrity=faults_on,
                      fused_install=args.fused_install,
                      kv_codec=args.kv_codec,
                      prefix_share=args.prefix_share, device=device)
    plan = flaps = None
    if faults_on:
        if args.fault_flap is not None:
            # the flap names a concrete scope, known only once the
            # engine's path tree exists; the LAST one flaps, so
            # replicated reads have somewhere to go
            lo, hi = (int(x) for x in args.fault_flap.split(":"))
            scopes = _fault_scopes(eng.pager.path)
            if not scopes:
                raise SystemExit("--fault-flap: path exposes no "
                                 "injectable fault scopes")
            flaps = {scopes[-1]: [(lo, hi)]}
        plan = _faults.install(FaultPlan(
            fault_seed, error_rate=args.fault_rate,
            timeout_rate=args.fault_timeout_rate,
            corrupt_rate=args.fault_corrupt, flaps=flaps))
    prompts, pfx_len = draw_prompts(args.seed, args.requests,
                                    args.prompt_len, cfg.vocab,
                                    args.prefix_share)
    t0 = time.time()
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new=args.max_new,
                           prefix_len=pfx_len))
    try:
        undrained = eng.run_until_drained()
    finally:
        if faults_on:
            # close the gate before teardown: the close's writebacks must
            # not draw from the fault schedule
            _faults.uninstall()
    dt = time.time() - t0
    summ = summarize_requests(eng.done)
    served, toks = summ["served"], summ["tokens"]
    failed = [r for r in eng.done if r.failed is not None]
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
    if plan is not None:
        snap = plan.snapshot()
        result["faults"] = {
            "seed": fault_seed, "plan": snap,
            "flaps": {k: [list(w) for w in v]
                      for k, v in (flaps or {}).items()},
            "retry": retry_policy.stats(),
            "shed": eng.shed_requests,
            "failed_reasons": {r.rid: r.failed for r in failed}}
        print(f"[serve:faults] seed={fault_seed} "
              f"errors={snap['errors']} timeouts={snap['timeouts']} "
              f"corruptions={snap['corruptions']} "
              f"flap_rejections={snap['flap_rejections']} "
              f"retries={retry_policy.retries} "
              f"giveups={retry_policy.giveups} "
              f"shed={eng.shed_requests}", flush=True)
    if eng.pager is not None:
        kv = _kv_stats_print(eng.pager, eng.access_path)
        if eng.fabric is not None:
            eng._drain_fabric_events()      # anything after the last step
            fs = eng.fabric.stats()
            result["fabric"] = {
                "shards": eng.kv_shards, "replicas": eng.kv_replicas,
                "epoch": fs["epoch"], "failed": fs["failed"],
                "failovers": fs["failovers"],
                "integrity_failures": fs.get("integrity_failures", 0),
                "degraded_writes": fs.get("degraded_writes", 0),
                "replicated_writes": fs.get("replicated_writes", 0),
                "pages_moved": fs["pages_moved"],
                "killed": eng.killed_member,
                "kill_step": eng.kill_step,
                "events": list(eng.fabric_events),
                "repair": eng.kill_repair}
            print(f"[serve:fabric] shards={eng.kv_shards} "
                  f"replicas={eng.kv_replicas} epoch={fs['epoch']} "
                  f"killed={eng.killed_member} "
                  f"failovers={fs['failovers']}", flush=True)
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
    if args.metrics:
        result["metrics"] = obs.default_registry().snapshot()
    if args.trace_out:
        n_ev = obs.trace.export(args.trace_out)
        print(f"[serve:trace] wrote {n_ev} events to {args.trace_out}",
              flush=True)
    return result


if __name__ == "__main__":
    main()
