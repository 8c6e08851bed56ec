"""Benchmark harness of the port: one module per paper table or figure.

Twin of ``benchmarks/run.py`` over the modules ported so far, with the
reference's module names, flags and JSON defaults, plus ``--device``
(``cuda``, the default, raises without a card; ``cpu`` runs every module
on the CPU, the kernels through their plain versions).  Prints
``name,us_per_call,derived`` CSV rows; on the card the first line names
the card and its power limit.  ``--quick`` shrinks the sweeps;
``--smoke`` is ``--quick`` with the reduced model (``reduce_for_smoke``)
in the serving modules and the install layouts, and writes the JSON
artifacts by default, as the reference's CI smoke does.

    python -m repro_torch.benchmarks.run [--quick|--smoke] [--only fig9]
        [--device cpu]

Ported: ``vmem_stream`` (Fig 8), ``host_device_bw`` (Figs 9-10,
15-18), ``contention`` (Figs 11-12), ``completion_modes`` (Figs
13-14), ``rdma_analogue`` (Figs 19-20), ``far_memory``, ``overlap``,
``fabric``, ``chaos``, ``serve_slo``, ``install_path`` and
``kv_capacity``.  Not ported yet, with the ROADMAP A item that brings
them: ``offload_step`` and ``e2e_step`` (A.6).

``main`` returns each module's result by name and exits non-zero when a
module raised (every byte check of the modules raises).
"""
from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch import obs
from repro_torch.benchmarks import (chaos, common, completion_modes,
                                    contention, fabric, far_memory,
                                    host_device_bw, install_path,
                                    kv_capacity, overlap, rdma_analogue,
                                    serve_slo, vmem_stream)
from repro_torch.device import resolve_device

MODULES = [
    ("fig8_vmem_stream", vmem_stream),
    ("fig9_18_host_device_bw", host_device_bw),
    ("fig11_12_contention", contention),
    ("fig13_14_completion_modes", completion_modes),
    ("fig19_20_rdma_analogue", rdma_analogue),
    ("farmem_tier_sweep", far_memory),
    ("serve_overlap", overlap),
    ("fabric_sweep", fabric),
    ("chaos_soak", chaos),
    ("serve_slo", serve_slo),
    ("install_path", install_path),
    ("kv_capacity", kv_capacity),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: quick sweeps, the reduced model, and "
                         "the JSON artifacts")
    ap.add_argument("--only", default="")
    ap.add_argument("--json", default="",
                    help="miss-pipeline metrics JSON path (farmem module); "
                         "defaults to BENCH_miss_pipeline.json with --smoke")
    ap.add_argument("--select-json", default="",
                    help="path-selection sweep JSON path (farmem module); "
                         "defaults to BENCH_path_select.json with --smoke")
    ap.add_argument("--fabric-json", default="",
                    help="fabric sweep JSON path (fabric module); "
                         "defaults to BENCH_fabric.json with --smoke")
    ap.add_argument("--chaos-json", default="",
                    help="chaos soak JSON path (chaos module); "
                         "defaults to BENCH_chaos.json with --smoke")
    ap.add_argument("--serve-slo-json", default="",
                    help="serving SLO bench JSON path (serve_slo "
                         "module); defaults to BENCH_serve_slo.json "
                         "with --smoke")
    ap.add_argument("--install-json", default="",
                    help="install-path bench JSON path (install_path "
                         "module); defaults to BENCH_install_path.json "
                         "with --smoke")
    ap.add_argument("--kv-capacity-json", default="",
                    help="KV capacity-multipliers bench JSON path "
                         "(kv_capacity module); defaults to "
                         "BENCH_kv_capacity.json with --smoke")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed of every benchmark's data, recorded in "
                         "every BENCH_*.json")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="enable tracing and write a Chrome trace-event "
                         "JSON of the whole run (Perfetto-loadable)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable live metrics (the registry snapshot "
                         "lands in every BENCH_*.json; on by default "
                         "with --smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    quick = args.quick or args.smoke
    common.set_bench_seed(args.seed)
    if args.trace_out:
        obs.trace.enable()
    if args.metrics or args.smoke:
        obs.metrics.enable_live()
    json_out = args.json or ("BENCH_miss_pipeline.json" if args.smoke
                             else "")
    select_out = args.select_json or ("BENCH_path_select.json"
                                      if args.smoke else "")
    fabric_out = args.fabric_json or ("BENCH_fabric.json"
                                      if args.smoke else "")
    chaos_out = args.chaos_json or ("BENCH_chaos.json"
                                    if args.smoke else "")
    serve_slo_out = args.serve_slo_json or ("BENCH_serve_slo.json"
                                            if args.smoke else "")
    install_out = args.install_json or ("BENCH_install_path.json"
                                        if args.smoke else "")
    kv_capacity_out = args.kv_capacity_json or ("BENCH_kv_capacity.json"
                                                if args.smoke else "")

    if dev.type == "cuda":
        print(f"# card: {common.card_line()}", flush=True)
    print("name,us_per_call,derived")
    results, failed = {}, []
    for name, mod in MODULES:
        if args.only and args.only not in name:
            continue
        print(f"# --- {name} ---", flush=True)
        kw = {"quick": quick, "device": dev}
        if mod is far_memory:
            kw.update(out=json_out, select_out=select_out,
                      smoke=args.smoke)
        elif mod is install_path:
            kw.update(out=install_out, smoke=args.smoke)
        elif mod is fabric:
            kw.update(out=fabric_out)
        elif mod is chaos:
            kw.update(out=chaos_out, smoke=args.smoke)
        elif mod is serve_slo:
            kw.update(out=serve_slo_out, smoke=args.smoke)
        elif mod is kv_capacity:
            kw.update(out=kv_capacity_out, smoke=args.smoke)
        elif mod is overlap:
            kw.update(smoke=args.smoke)
        try:
            results[name] = mod.run(**kw)
        except Exception:
            failed.append(name)
            traceback.print_exc()
    if args.trace_out:
        n_ev = obs.trace.export(args.trace_out)
        print(f"# wrote {n_ev} trace events to {args.trace_out}",
              flush=True)
    if failed:
        print(f"# FAILED: {failed}", file=sys.stderr)
        sys.exit(1)
    print("# all benchmarks complete")
    return results


if __name__ == "__main__":
    main()
