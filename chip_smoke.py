#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports the port (``src/repro_torch``) and nothing of the JAX package,
and it stops at the first failing phase with a non-zero exit:

1. prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA source of the port with ``nvcc`` and prints the build time
   and ``ptxas``' report;
2. kernel phase: at the qwen2-0.5b cache layout (max_len 128 and 2048,
   B=4 slots, G=4 pages, random caches) holds ``pack_page`` and
   ``install_pages`` byte for byte against their plain PyTorch versions,
   and times kernel, plain version and one library call with CUDA events
   (device time, median of repeats);
3. measures the pinned host->device copy rate;
4. serve phase: full-width qwen2-0.5b (bf16, random weights from the
   seed) through ``repro_torch.launch.serve.main`` with KV paging over
   xdma, 8 requests on 4 slots, 16 new tokens each, after the same run
   without paging.  Both kernels' launch counts are zeroed just before
   the paged run and must be > 0 just after;
   every request must install through the fused path; the outputs must
   equal those of the run without paging and of one with ``--no-overlap``;
5. reference check: at the smoke size in float32, the model's prefill
   logits on the card agree with the CPU's within 1e-4;

then prints a ``kernels`` JSON line and, last, the device JSON line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak, 700 W limit
PACK_SOURCE = "src/repro_torch/csrc/page_install.cu"


def device_time_ms(fn, calls: int = 20, repeats: int = 9) -> float:
    """Median device milliseconds per ``fn()`` call.  A sleep kernel
    holds the stream while the host enqueues ``calls`` calls, so the two
    events bracket back-to-back device work, not the host's enqueue."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def kernel_phase(max_len: int, B: int = 4, G: int = 4) -> dict:
    """Check both kernels against their plain versions at the qwen2-0.5b
    layout and time them; returns the numbers for the kernels line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import torch_dtype
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T

    cfg = get_config("qwen2-0.5b")
    dev = torch.device("cuda")
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

    single = rand_leaves(False)
    page_k = pi.pack_page(layout, single)
    page_p = pi.pack_page_torch(layout, single)
    torch.cuda.synchronize()
    pack_err = int((page_k.int() - page_p.int()).abs().max())
    assert pack_err == 0, f"pack_page differs from its plain version " \
                          f"(max byte diff {pack_err})"

    stack = torch.stack([pi.pack_page_torch(layout, rand_leaves(False))
                         for _ in range(G)])
    entries = [(stack, g) for g in range(G)]
    slots = [2, 0, 3, 1][:G]
    base = rand_leaves(True)
    got = pi.install_pages(layout, [b.clone() for b in base], entries, slots)
    want = pi.install_pages_torch(layout, [b.clone() for b in base],
                                  entries, slots)
    torch.cuda.synchronize()
    inst_err = max(int((g.view(torch.uint8).int() - w.view(torch.uint8)
                        .int()).abs().max()) for g, w in zip(got, want))
    assert inst_err == 0, f"install_pages differs from its plain version " \
                          f"(max byte diff {inst_err})"

    # library yardsticks: one torch.cat; per-leaf index_copy_ from views
    byte_views = [l.reshape(-1).view(torch.uint8) for l in single]
    typed = [[stack[g, sp.offset:sp.offset + sp.nbytes]
              .view(torch_dtype(sp.dtype)).reshape(sp.shape)
              for sp in layout.leaves] for g in range(G)]
    idx = [torch.tensor([s], device=dev) for s in slots]
    leaves_t = [b.clone() for b in base]

    def library_install():
        for g in range(G):
            for sp in layout.leaves:
                leaves_t[sp.index].index_copy_(sp.slot_axis, idx[g],
                                               typed[g][sp.index])

    t = {
        "pack_ms": device_time_ms(lambda: pi.pack_page(layout, single)),
        "pack_plain_ms": device_time_ms(
            lambda: pi.pack_page_torch(layout, single)),
        "pack_library_ms": device_time_ms(lambda: torch.cat(byte_views)),
        "install_ms": device_time_ms(
            lambda: pi.install_pages(layout, leaves_t, entries, slots)),
        "install_plain_ms": device_time_ms(
            lambda: pi.install_pages_torch(layout, leaves_t, entries,
                                           slots)),
        "install_library_ms": device_time_ms(library_install),
    }
    pb = layout.page_bytes
    t.update(page_bytes=pb, pack_err=pack_err, install_err=inst_err,
             pack_bound_ms=2 * pb / HBM_BYTES_PER_S * 1e3,
             install_bound_ms=2 * pb * G / HBM_BYTES_PER_S * 1e3)
    print(f"[kernels] max_len={max_len} B={B} G={G} page={pb}B "
          f"pack: kernel_ms={t['pack_ms']:.5f} "
          f"plain_ms={t['pack_plain_ms']:.5f} "
          f"library_ms={t['pack_library_ms']:.5f} "
          f"bound_us={t['pack_bound_ms'] * 1e3:.3f} | "
          f"install: kernel_ms={t['install_ms']:.5f} "
          f"plain_ms={t['install_plain_ms']:.5f} "
          f"library_ms={t['install_library_ms']:.5f} "
          f"bound_us={t['install_bound_ms'] * 1e3:.3f}", flush=True)
    return t


def pinned_h2d_gbps(nbytes: int = 64 << 20, repeats: int = 10) -> float:
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    rates = []
    for _ in range(repeats + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        rates.append(nbytes / (start.elapsed_time(end) * 1e-3) / 1e9)
    return statistics.median(rates[2:])


def serve_phase() -> dict:
    from repro_torch.kernels import page_install as pi
    from repro_torch.launch import serve

    common = ["--arch", "qwen2-0.5b", "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda"]
    paged = common + ["--kv-paging", "--access-path", "xdma"]
    # the run without paging goes first: it also takes the process's
    # first-use costs (cuBLAS handles, allocator growth) off the paged run
    plain = serve.main(common)
    pi.pack_page.launches = 0
    pi.install_pages.launches = 0
    res = serve.main(paged)
    launches = {"pack_page": pi.pack_page.launches,
                "install_pages": pi.install_pages.launches}
    print(f"[serve] launches={launches} install={res['install']} "
          f"tok_per_s={res['tok_per_s']:.2f} "
          f"ttft_p50_ms={res['latency']['ttft_s']['p50'] * 1e3:.2f}",
          flush=True)
    assert all(n > 0 for n in launches.values()), launches
    assert res["requests"] == 8 and res["undrained"] == 0, res["requests"]
    assert res["install"]["fused"] == 8, res["install"]
    assert res["install"]["fallback"] == 0, res["install"]
    outs = res["outputs"]
    assert sorted(outs) == list(range(8)) and all(
        len(v) == 16 and all(0 <= t < 151936 for t in v)
        for v in outs.values()), outs
    assert plain["outputs"] == outs, "outputs differ with paging off"
    serial = serve.main(paged + ["--no-overlap"])
    assert serial["outputs"] == outs, "outputs differ with --no-overlap"
    return {"result": res, "launches": launches}


def reference_check() -> float:
    """Smoke-size float32 prefill on the card vs on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.interop import tree_map
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 12))
    logits = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                           device=dev)}
        _, lg = lm.make_prefill_step(cfg)(p, batch,
                                          T.init_cache(cfg, 1, 32, dev))
        logits[dev] = lg.float().cpu()
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    print(f"[reference] smoke float32 prefill logits, cuda vs cpu: "
          f"max_abs_err={err:.3e}", flush=True)
    assert err < 1e-4, err
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    build.build(["page_install"])
    build_s = time.perf_counter() - t0
    print(f"[build] page_install.cu in {build_s:.2f}s (wall)", flush=True)
    for name, (secs, log) in build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {secs:.2f}s\n{log.strip()}", flush=True)

    k128 = kernel_phase(128)
    kernel_phase(2048)
    gbps = pinned_h2d_gbps()
    print(f"[h2d] pinned host->device 64 MiB: {gbps} GB/s", flush=True)
    served = serve_phase()
    res = served["result"]
    print(f"[serve] tok/s={res['tok_per_s']:.2f} "
          f"ttft_p50_ms={res['latency']['ttft_s']['p50'] * 1e3:.2f} "
          f"pinned_h2d_gbps={gbps}", flush=True)
    reference_check()

    kernels = [
        {"name": "pack_page", "route": "cuda", "source": PACK_SOURCE,
         "replaces": "src/repro/kernels/page_install.py:477",
         "launches": served["launches"]["pack_page"],
         "max_abs_err": float(k128["pack_err"]), "ms": k128["pack_ms"],
         "plain_ms": k128["pack_plain_ms"],
         "bound_ms": k128["pack_bound_ms"], "bound_by": "bytes",
         "library_ms": k128["pack_library_ms"]},
        {"name": "install_pages", "route": "cuda", "source": PACK_SOURCE,
         "replaces": "src/repro/kernels/page_install.py:355",
         "launches": served["launches"]["install_pages"],
         "max_abs_err": float(k128["install_err"]),
         "ms": k128["install_ms"], "plain_ms": k128["install_plain_ms"],
         "bound_ms": k128["install_bound_ms"], "bound_by": "bytes",
         "library_ms": k128["install_library_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
