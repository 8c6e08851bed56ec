"""Host and device time of one ``install_pages`` call, for any checkout of
the port.

Times the page install at the served cache layouts (qwen2-0.5b at
max_len 128 and 2048, recurrentgemma-2b at 2304; B=4, G=4 pages into
slots 2, 0, 3, 1), the same inputs ``chip_smoke.py``'s kernel phase
uses, and checks each install byte for byte against
``install_pages_torch``.  Per layout it prints one ``[install]`` line:

* ``host_us_per_call``: wall time to issue 20 back-to-back calls, the
  card synchronised before and not after, over 20; the median of
  ``--rounds`` rounds, with their least and greatest;
* ``kernel_ms``: device ms per call (CUDA events, median of 9 x 20);
* ``launches_per_call`` and the byte bound (2 x page bytes x G over
  3.35 TB/s).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed, so
two checkouts compare in one process layout; run the file by its path,
not with ``-m``:

    python src/repro_torch/benchmarks/install_host.py [--src DIR]
        [--rounds R] [--quick] [--device cpu]

``--device cpu`` times the plain version (host time only; the device
fields print as not measured), ``--quick`` only the first layout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

LAYOUTS = (("qwen2-0.5b", 128), ("qwen2-0.5b", 2048),
           ("recurrentgemma-2b", 2304))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak, 700 W limit
B, G, SLOTS, CALLS = 4, 4, (2, 0, 3, 1), 20


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


def measure(arch: str, max_len: int, dev, rounds: int) -> dict:
    import torch
    from repro_torch.benchmarks.common import time_call
    from repro_torch.configs import get_config
    from repro_torch.interop import torch_dtype
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    layout = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                            T.init_cache(cfg, B, max_len, "meta"), B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(max_len)

    def rand_leaves(batch_shapes: bool):
        out = []
        for sp in layout.leaves:
            shape = sp.batch_shape if batch_shapes else sp.shape
            dt = torch_dtype(sp.dtype)
            if dt.is_floating_point:
                out.append(torch.randn(shape, generator=gen, device=dev)
                           .to(dt))
            else:
                out.append(torch.randint(0, 1000, shape, generator=gen,
                                         device=dev, dtype=dt))
        return out

    stack = torch.stack([pi.pack_page_torch(layout, rand_leaves(False))
                         for _ in range(G)])
    entries = [(stack, g) for g in range(G)]
    leaves = rand_leaves(True)
    want = pi.install_pages_torch(layout, [b.clone() for b in leaves],
                                  entries, list(SLOTS))
    pi.install_pages.launches = 0
    pi.install_pages(layout, leaves, entries, list(SLOTS))
    launches = pi.install_pages.launches
    for got, ref in zip(leaves, want):
        if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
            raise AssertionError(f"install_pages differs from its plain "
                                 f"version at {arch} max_len={max_len}")

    def call():
        pi.install_pages(layout, leaves, entries, list(SLOTS))

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
    cuda = dev.type == "cuda"
    kernel_ms = time_call(call, repeats=9, warmup=3, calls=CALLS,
                          device=dev) * 1e3 if cuda else None
    return {"arch": arch, "max_len": max_len,
            "page_bytes": layout.page_bytes, "launches_per_call": launches,
            "host_us_per_call": statistics.median(host),
            "host_us_min": min(host), "host_us_max": max(host),
            "kernel_ms": kernel_ms,
            "bound_ms": 2 * layout.page_bytes * G / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[2],
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--quick", action="store_true",
                    help="only the first layout")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    _import_port(args.src)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    rows = []
    for arch, max_len in LAYOUTS[:1] if args.quick else LAYOUTS:
        r = measure(arch, max_len, dev, args.rounds)
        kms = "not measured" if r["kernel_ms"] is None \
            else f"{r['kernel_ms']:.6f}"
        print(f"[install] src={args.src} {arch} max_len={max_len} B={B} "
              f"G={G} launches_per_call={r['launches_per_call']} "
              f"host_us_per_call={r['host_us_per_call']:.2f} "
              f"(min {r['host_us_min']:.2f}, max {r['host_us_max']:.2f}, "
              f"{args.rounds} rounds) kernel_ms={kms} "
              f"bound_ms={r['bound_ms']:.6f}", flush=True)
        rows.append(r)
    print(json.dumps({"src": str(args.src), "device": str(dev),
                      "install": rows}))
    return rows


if __name__ == "__main__":
    main()
