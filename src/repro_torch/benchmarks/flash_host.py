"""Host and device time of one ``flash_attention`` call (the wrapper, as
the model calls it), for any checkout of the port.

Times the bf16 forward at qwen2-0.5b's train shape (B=8, S=128, 14 q
heads on 2 KV heads, d_head 64, causal) and at its serve prefill
(B=1, S=12), after checking each call against ``attention_chunked`` in
float32 (2e-2 abs + rel, as ``chip_smoke.py``'s checks).  Per shape it
prints one ``[flash-host]`` line:

* ``host_us_per_call``: wall time to issue 20 back-to-back calls, the
  card synchronised before and not after, over 20; the median of
  ``--rounds`` rounds, with their least and greatest;
* ``kernel_ms``: device ms per call (CUDA events, median of 9 x 20).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed, so
two checkouts compare in one process layout; run the file by its path,
not with ``-m``:

    python src/repro_torch/benchmarks/flash_host.py [--src DIR]
        [--rounds R] [--device cpu]

``--device cpu`` times the plain version (host time only; the device
field prints as not measured).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

SHAPES = ((8, 128, 14, 2, 64), (1, 12, 14, 2, 64))
CALLS = 20


def _import_port(src: Path):
    """Put ``src`` first on the path and import its ``repro_torch``."""
    loaded = sys.modules.get("repro_torch")
    if loaded is not None and \
            Path(loaded.__file__).resolve().parent.parent != src.resolve():
        raise SystemExit(f"repro_torch is already imported from "
                         f"{loaded.__file__}; run this file by its path")
    sys.path.insert(0, str(src))
    import repro_torch
    return repro_torch


def measure(shape, dev, rounds: int) -> dict:
    import torch
    from repro_torch.benchmarks.common import time_call
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KV, dh = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, dh), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (H, KV, KV))
    want = FA.attention_chunked(q.float(), k.float(), v.float())
    diff = (FA.flash_attention(q, k, v).float() - want).abs()
    err = float(diff.max())
    if bool((diff > 2e-2 + 2e-2 * want.abs()).any()):
        raise AssertionError(f"flash_attention at {shape} differs from "
                             f"its float32 plain version: {err}")

    def call():
        FA.flash_attention(q, k, v)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    host = []
    for _ in range(rounds):
        call()
        sync()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        host.append((time.perf_counter() - t0) / CALLS * 1e6)
        sync()
    kernel_ms = time_call(call, repeats=9, warmup=3, calls=CALLS,
                          device=dev) * 1e3 if dev.type == "cuda" else None
    return {"shape": list(shape), "max_abs_err": err,
            "host_us_per_call": statistics.median(host),
            "host_us_min": min(host), "host_us_max": max(host),
            "kernel_ms": kernel_ms}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    _import_port(args.src)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    rows = []
    for shape in SHAPES:
        r = measure(shape, dev, args.rounds)
        kms = "not measured" if r["kernel_ms"] is None \
            else f"{r['kernel_ms']:.6f}"
        print(f"[flash-host] src={args.src} bf16 (B, S, H, KV, dh)={shape} "
              f"host_us_per_call={r['host_us_per_call']:.2f} "
              f"(min {r['host_us_min']:.2f}, max {r['host_us_max']:.2f}, "
              f"{args.rounds} rounds) kernel_ms={kms} "
              f"max_abs_err={r['max_abs_err']:.3e}", flush=True)
        rows.append(r)
    print(json.dumps({"src": str(args.src), "device": str(dev),
                      "flash": rows}))
    return rows


if __name__ == "__main__":
    main()
