#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports the port (``src/repro_torch``) and nothing of the JAX package,
and it stops at the first failing phase with a non-zero exit:

1. prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA source of the port (``page_install.cu``, ``rg_lru.cu``,
   ``flash_attention.cu``: one ``nvcc`` each, all started together) and
   prints the build times and ``ptxas``' report;
2. page kernel phase: at the qwen2-0.5b cache layout (max_len 128 and
   2048) and the recurrentgemma-2b layout (max_len 2304), B=4 slots, G=4
   pages, random caches, holds ``pack_page`` and ``install_pages`` byte
   for byte against their plain PyTorch versions (an install whose slots
   repeat a slot included: the last page wins), and times kernel, plain
   version and one library call with CUDA events (device time, median of
   repeats);
3. ``rg_lru_scan`` phase at (B, T, W) = (1, 2100, 2560), the hybrid
   serve prefill, and (4, 2048, 2560): kernel against its plain float32
   loop within 1e-5, and timed;
4. ``flash_attention`` phase: timed at the hybrid prefill (S=2100, 10
   heads, 1 KV head, d_head 256, window 2048, bf16) and at qwen2-0.5b's
   (S=2048, 14/2 heads, d_head 64, causal, bf16), held against the plain
   version within 2e-2 (bf16) and checked within 2e-5 (float32) at small
   shapes: logit cap, bidirectional, ragged S=12, d_head 256;
   ``scaled_dot_product_attention`` with an explicit boolean mask is
   timed beside it as a yardstick the port never calls;
5. measures the pinned host->device copy rate;
6. serve phases, each through ``repro_torch.launch.serve.main``:
   full-width qwen2-0.5b (8 requests of 12 tokens on 4 slots) and
   full-width recurrentgemma-2b (8 requests of 2100 tokens on 4 slots,
   max_len 2304, so its 2048-row ring cache wraps), bf16, random weights
   from the seed; each without paging, then with KV paging over xdma,
   then paged with ``--no-overlap``.  Every kernel launch count is zeroed
   just before each paged run and read just after: the qwen2 run must
   launch the page kernels and the flash kernel, the hybrid run all four;
   every request must install through the fused path; the three runs'
   outputs must be equal;
7. reference check: at the smoke size in float32, qwen2-0.5b's and
   recurrentgemma-2b's prefill logits on the card agree with the CPU's
   within 1e-4 (the hybrid prompt of 40 tokens overruns its window of
   32);

then prints the card line, a ``kernels`` JSON line and, last, the device
JSON line.
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
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SOURCES = ("page_install", "rg_lru", "flash_attention")
PACK_SOURCE = "src/repro_torch/csrc/page_install.cu"


def device_time_ms(fn, calls: int = 20, repeats: int = 9,
                   warmup: int = 3) -> float:
    """Median device milliseconds per ``fn()`` call.  A sleep kernel
    holds the stream while the host enqueues ``calls`` calls, so the two
    events bracket back-to-back device work, not the host's enqueue."""
    import torch
    for _ in range(warmup):
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


def kernel_phase(max_len: int, arch: str = "qwen2-0.5b", B: int = 4,
                 G: int = 4) -> dict:
    """Check both page kernels against their plain versions at ``arch``'s
    cache layout and time them; returns the numbers for the kernels
    line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import torch_dtype
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
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
    # a slot that repeats: the last page for it wins, as in the reference
    rep = [1, 3, 1, 1][:G]
    got = pi.install_pages(layout, [b.clone() for b in base], entries, rep)
    want = pi.install_pages_torch(layout, [b.clone() for b in base],
                                  entries, rep)
    torch.cuda.synchronize()
    rep_err = max(int((g.view(torch.uint8).int() - w.view(torch.uint8)
                       .int()).abs().max()) for g, w in zip(got, want))
    assert rep_err == 0, f"install_pages with repeated slots differs " \
                         f"from its plain version (max byte diff {rep_err})"

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
    print(f"[kernels] {arch} max_len={max_len} B={B} G={G} page={pb}B "
          f"pack: kernel_ms={t['pack_ms']:.5f} "
          f"plain_ms={t['pack_plain_ms']:.5f} "
          f"library_ms={t['pack_library_ms']:.5f} "
          f"bound_us={t['pack_bound_ms'] * 1e3:.3f} | "
          f"install: kernel_ms={t['install_ms']:.5f} "
          f"plain_ms={t['install_plain_ms']:.5f} "
          f"library_ms={t['install_library_ms']:.5f} "
          f"bound_us={t['install_bound_ms'] * 1e3:.3f}", flush=True)
    return t


def rg_lru_phase(B: int, T: int, W: int) -> dict:
    """Hold ``rg_lru_scan`` against its plain float32 loop (both are
    sequential float32, each step one rounded multiply and one rounded
    add, so they agree to 1e-5 and in practice bit for bit) and time
    both."""
    import torch
    from repro_torch.kernels import rg_lru as R

    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + W)
    a = 0.5 + 0.499 * torch.rand((B, T, W), generator=gen, device="cuda")
    b = torch.randn((B, T, W), generator=gen, device="cuda")
    h0 = torch.randn((B, W), generator=gen, device="cuda")
    got = R.rg_lru_scan(a, b, h0)
    want = R.rg_lru_scan_torch(a, b, h0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()), "rg_lru_scan: non-finite"
    assert err <= 1e-5, f"rg_lru_scan differs from its plain version: {err}"
    t = {"err": err,
         "ms": device_time_ms(lambda: R.rg_lru_scan(a, b, h0)),
         # the plain loop issues 2 T ops: one call, three repeats
         "plain_ms": device_time_ms(lambda: R.rg_lru_scan_torch(a, b, h0),
                                    calls=1, repeats=3, warmup=1),
         # a, b read and h written once (12 B T W), h0 read once (4 B W);
         # the final state is h[:, -1], not a separate output
         "bound_ms": (12 * B * T * W + 4 * B * W) / HBM_BYTES_PER_S * 1e3}
    print(f"[rg_lru] B={B} T={T} W={W} max_abs_err={err:.3e} "
          f"kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
          f"bound_ms={t['bound_ms']:.5f}", flush=True)
    return t


def live_pairs(S: int, causal: bool, window) -> int:
    """(q, k) pairs that the mask keeps."""
    total = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo + 1
    return total


def _qkv(B, S, H, KV, dh, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn((B, S, n, dh), generator=gen, device="cuda")
            .to(dtype) for n in (H, KV, KV)]


def flash_check(B, S, H, KV, dh, dtype, tol, plain_f32=False,
                **kw) -> float:
    """Kernel against the plain version; returns the max abs error.

    With ``plain_f32`` the plain version runs in float32 on the same
    (bf16-valued) inputs: in bf16 it rounds the scores to bf16 before its
    softmax, which at logit-cap scale (scores near 30, an ulp of 0.125)
    is itself off by more than the 2e-2 bar, while the kernel keeps its
    scores in float32."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(B, S, H, KV, dh, dtype, seed=S + H + dh)
    if kw.get("logit_cap"):
        q, k = 5.0 * q, 5.0 * k
    got = FA.flash_attention(q, k, v, **kw)
    plain_in = [x.float() for x in (q, k, v)] if plain_f32 else (q, k, v)
    want = FA.attention_chunked(*plain_in, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    note = ""
    if plain_f32:   # shown, not held: how far the bf16 plain version is off
        note = " vs_plain_bf16=%.3e" % float(
            (got.float() - FA.attention_chunked(q, k, v, **kw).float())
            .abs().max())
    print(f"[flash] check B={B} S={S} H={H} KV={KV} dh={dh} {dtype} {kw} "
          f"plain={'float32' if plain_f32 else dtype} "
          f"max_abs_err={err:.3e}{note}", flush=True)
    assert bool(torch.isfinite(got).all()), "flash_attention: non-finite"
    assert not bool(bad.any()), f"flash_attention differs from its plain " \
                                f"version beyond {tol}: {err}"
    return err


def flash_phase(B, S, H, KV, dh, *, window=None, causal=True) -> dict:
    """Time the kernel, its plain version and SDPA (a yardstick only) in
    bf16 at one prefill shape, after holding the kernel to 2e-2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    err = flash_check(B, S, H, KV, dh, torch.bfloat16, 2e-2, causal=causal,
                      window=window)
    q, k, v = _qkv(B, S, H, KV, dh, torch.bfloat16, seed=S + H + dh)
    i = torch.arange(S, device="cuda")
    mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = float((lib.float() - FA.flash_attention(
        q, k, v, causal=causal, window=window).float()).abs().max())
    pairs = live_pairs(S, causal, window)
    flops = 4 * B * H * dh * pairs
    nbytes = (2 * B * S * H * dh + 2 * B * S * KV * dh) * 2
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    t = {"err": err, "live_pairs": pairs, "flops": flops, "bytes": nbytes,
         "ms": device_time_ms(lambda: FA.flash_attention(
             q, k, v, causal=causal, window=window)),
         "plain_ms": device_time_ms(lambda: FA.attention_chunked(
             q, k, v, causal=causal, window=window), calls=3, repeats=5),
         "library_ms": device_time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, attn_mask=mask, enable_gqa=True)),
         "bound_ms": max(t_ops, t_bytes) * 1e3,
         "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(f"[flash] B={B} S={S} H={H} KV={KV} dh={dh} window={window} "
          f"live_pairs={pairs} GFLOP={flops / 1e9:.3f} MB={nbytes / 1e6:.3f}"
          f" max_abs_err={err:.3e} sdpa_vs_kernel={lib_err:.3e} "
          f"kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
          f"sdpa_ms={t['library_ms']:.5f} bound_ms={t['bound_ms']:.5f} "
          f"({t['bound_by']}; TFLOP/s={flops / t['ms'] / 1e9:.2f})",
          flush=True)
    return t


def flash_checks() -> None:
    """Edge cases at small shapes, correctness only: the float32 kernel
    (logit cap, bidirectional, ragged S, d_head 256 with a window) and
    the bf16 tensor-core kernel (the qwen2-0.5b serve path's own 12-token
    prefill, ragged S, bidirectional, window, logit cap)."""
    import torch
    f32 = torch.float32
    flash_check(1, 128, 2, 2, 64, f32, 2e-5, logit_cap=30.0)
    flash_check(1, 256, 4, 4, 64, f32, 2e-5, causal=False)
    flash_check(2, 12, 4, 2, 16, f32, 2e-5)
    flash_check(1, 200, 4, 1, 256, f32, 2e-5, window=64)
    bf16 = torch.bfloat16
    flash_check(1, 12, 14, 2, 64, bf16, 2e-2)
    flash_check(2, 12, 4, 2, 16, bf16, 2e-2)
    flash_check(2, 65, 4, 2, 64, bf16, 2e-2)
    flash_check(1, 256, 4, 4, 128, bf16, 2e-2, causal=False)
    flash_check(1, 300, 4, 1, 256, bf16, 2e-2, window=100)
    flash_check(1, 128, 2, 2, 64, bf16, 2e-2, plain_f32=True, logit_cap=30.0)


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


def _counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import page_install as pi
    from repro_torch.kernels import rg_lru as R
    return {"pack_page": pi.pack_page, "install_pages": pi.install_pages,
            "flash_attention": FA.flash_attention,
            "rg_lru_scan": R.rg_lru_scan}


def serve_phase(arch: str, flags, vocab: int, needs) -> dict:
    """Serve ``arch`` without paging, with paging (every launch count
    zeroed just before and read just after) and paged with
    ``--no-overlap``; the three must give the same outputs, and the
    kernels of ``needs`` must have launched in the paged run."""
    from repro_torch.launch import serve

    common = ["--arch", arch, "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda"] + list(flags)
    paged = common + ["--kv-paging", "--access-path", "xdma"]
    # the run without paging goes first: it also takes the process's
    # first-use costs (cuBLAS handles, allocator growth) off the paged run
    plain = serve.main(common)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    res = serve.main(paged)
    launches = {name: fn.launches for name, fn in counters.items()}
    lat = res["latency"]
    print(f"[serve] {arch} launches={launches} install={res['install']} "
          f"tok_per_s={res['tok_per_s']:.2f} "
          f"ttft_p50_ms={lat['ttft_s']['p50'] * 1e3:.2f} "
          f"tpot_p50_ms={lat['tpot_s']['p50'] * 1e3:.2f} | unpaged "
          f"tok_per_s={plain['tok_per_s']:.2f} ttft_p50_ms="
          f"{plain['latency']['ttft_s']['p50'] * 1e3:.2f}", flush=True)
    assert all(launches[n] > 0 for n in needs), (needs, launches)
    assert res["requests"] == 8 and res["undrained"] == 0, res["requests"]
    assert res["install"]["fused"] == 8, res["install"]
    assert res["install"]["fallback"] == 0, res["install"]
    outs = res["outputs"]
    assert sorted(outs) == list(range(8)) and all(
        len(v) == 16 and all(0 <= t < vocab for t in v)
        for v in outs.values()), outs
    assert plain["outputs"] == outs, f"{arch}: outputs differ with paging off"
    serial = serve.main(paged + ["--no-overlap"])
    assert serial["outputs"] == outs, f"{arch}: outputs differ with " \
                                      f"--no-overlap"
    print(f"[serve] {arch} --no-overlap tok_per_s={serial['tok_per_s']:.2f}"
          f" ttft_p50_ms={serial['latency']['ttft_s']['p50'] * 1e3:.2f}",
          flush=True)
    return {"result": res, "launches": launches}


def reference_check(arch: str, prompt_len: int, max_len: int) -> float:
    """Smoke-size float32 prefill on the card vs on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.interop import tree_map
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, prompt_len))
    logits = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                           device=dev)}
        _, lg = lm.make_prefill_step(cfg)(p, batch,
                                          T.init_cache(cfg, 1, max_len, dev))
        logits[dev] = lg.float().cpu()
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    print(f"[reference] {arch} smoke float32 prefill of {prompt_len} tokens, "
          f"logits cuda vs cpu: max_abs_err={err:.3e}", flush=True)
    assert bool(torch.isfinite(logits["cuda"]).all())
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

    # float32 products in full float32 on both sides of every check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[torch] {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build.build(SOURCES)
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(SOURCES)} in {build_s:.2f}s (wall)",
          flush=True)
    for name, (secs, log) in build.BUILD_LOG.items():
        print(f"[build] {name}: nvcc {secs:.2f}s\n{log.strip()}", flush=True)

    k128 = kernel_phase(128)
    kernel_phase(2048)
    kernel_phase(2304, arch="recurrentgemma-2b")
    lru = rg_lru_phase(1, 2100, 2560)
    rg_lru_phase(4, 2048, 2560)
    flash_checks()
    fl = flash_phase(1, 2100, 10, 1, 256, window=2048)
    flash_phase(1, 2048, 14, 2, 64)
    flash_phase(1, 12, 14, 2, 64)   # the qwen2-0.5b serve path's prefill
    gbps = pinned_h2d_gbps()
    print(f"[h2d] pinned host->device 64 MiB: {gbps} GB/s", flush=True)
    page_kernels = ("pack_page", "install_pages")
    qwen = serve_phase("qwen2-0.5b", [], 151936,
                       page_kernels + ("flash_attention",))
    hybrid = serve_phase(
        "recurrentgemma-2b", ["--prompt-len", "2100", "--max-len", "2304"],
        256000, page_kernels + ("flash_attention", "rg_lru_scan"))
    reference_check("qwen2-0.5b", 12, 32)
    reference_check("recurrentgemma-2b", 40, 64)

    # launches: the sum over the two paged serve runs, each counted from 0
    launches = {n: qwen["launches"][n] + hybrid["launches"][n]
                for n in qwen["launches"]}
    flash_src = "src/repro_torch/csrc/flash_attention.cu"
    kernels = [
        {"name": "pack_page", "route": "cuda", "source": PACK_SOURCE,
         "replaces": "src/repro/kernels/page_install.py:477",
         "launches": launches["pack_page"],
         "max_abs_err": float(k128["pack_err"]), "ms": k128["pack_ms"],
         "plain_ms": k128["pack_plain_ms"],
         "bound_ms": k128["pack_bound_ms"], "bound_by": "bytes",
         "library_ms": k128["pack_library_ms"]},
        {"name": "install_pages", "route": "cuda", "source": PACK_SOURCE,
         "replaces": "src/repro/kernels/page_install.py:355",
         "launches": launches["install_pages"],
         "max_abs_err": float(k128["install_err"]),
         "ms": k128["install_ms"], "plain_ms": k128["install_plain_ms"],
         "bound_ms": k128["install_bound_ms"], "bound_by": "bytes",
         "library_ms": k128["install_library_ms"]},
        {"name": "flash_attention", "route": "cuda", "source": flash_src,
         "replaces": "src/repro/kernels/flash_attention.py:33",
         "launches": launches["flash_attention"],
         "max_abs_err": fl["err"], "ms": fl["ms"],
         "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
         "bound_by": fl["bound_by"], "library_ms": fl["library_ms"]},
        {"name": "rg_lru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rg_lru.cu",
         "replaces": "src/repro/kernels/rg_lru.py:24",
         "launches": launches["rg_lru_scan"], "max_abs_err": lru["err"],
         "ms": lru["ms"], "plain_ms": lru["plain_ms"],
         "bound_ms": lru["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "library_note": "no single PyTorch call computes a linear "
                         "recurrence"},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
