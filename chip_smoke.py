#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports the port (``src/repro_torch``) and nothing of the JAX package,
and it stops at the first failing phase with a non-zero exit:

1. prints the card's name and power limit (``nvidia-smi``), then builds
   every CUDA source of the port (``page_install.cu``, ``rg_lru.cu``,
   ``flash_attention.cu``, ``stream_copy.cu``: one ``nvcc`` each, all
   started together) and
   prints the build times, ``ptxas``' report and one line of registers
   and spills per head width of the bf16 flash kernel;
2. page kernel phase: at the qwen2-0.5b cache layout (max_len 128 and
   2048) and the recurrentgemma-2b layout (max_len 2304), B=4 slots, G=4
   pages, random caches, holds ``pack_page`` and ``install_pages`` byte
   for byte against their plain PyTorch versions (an install whose slots
   repeat a slot included: the last page wins), prints both kernels'
   launches per call (the install must take one), times kernel, plain
   version and one library call with CUDA events (device time, median of
   9 repeats of 20 calls) and prints the install's host microseconds per
   call and its share of the bound;
3. ``rg_lru_scan`` phase at (B, T, W) = (1, 2100, 2560), the hybrid
   serve prefill, and (4, 2048, 2560): kernel bit-equal to its plain
   float32 loop (``torch.equal``), timed, and printed with its launch
   plan (CTAs, tile, stages, bytes in flight, TMA or cp.async route);
   then bit-equal at three ragged shapes: (2, 1001, 776) on the TMA
   route, (2, 1001, 770) and (1, 333, 130) on the cp.async route
   (``W % 4 != 0``), the last two without ``h0``;
4. ``flash_attention`` phase: timed at the hybrid prefill (S=2100, 10
   heads, 1 KV head, d_head 256, window 2048, bf16) and at qwen2-0.5b's
   (S=2048, 14/2 heads, d_head 64, causal, bf16) and at the qwen2-0.5b
   serve prefill (S=12), with TFLOP/s and the share of the bound; held
   against the plain version within 2e-2 (bf16) and checked within 2e-5
   (float32) at small shapes: logit cap, bidirectional, ragged S=12,
   d_head 256; the bf16 kernel also at the hybrid prefill, (1, 2100,
   8/2, 128), B=2 at d_head 256 with a window, d_head 32 and a (B, H, S,
   dh)-strided view, against the plain version in float32; every check
   also holds each 64-row block's relative RMS error within 1e-2;
   ``scaled_dot_product_attention`` with an explicit boolean mask is
   timed beside it as a yardstick the port never calls;
5. ``stream_copy`` phase: holds the kernel byte for byte against its
   input on the reference test's grid and the full Fig-8 grid in
   float32, bfloat16 and int32 (-0.0 and NaN payloads planted), runs the
   Fig-8 sweep (``repro_torch.benchmarks.vmem_stream.run``, launches
   counted) and prints its rows, and times kernel, plain version
   (``clone``) and ``copy_`` (a yardstick) at one Fig-8 cell (512, 512)
   and at (65536, 1024) float32, 256 MiB, each row with its CTA count P
   and slice bytes;
6. codec check: the device decode of a page equals the numpy decode for
   int8 and bf16 at both archs' serve layouts (and qwen2-0.5b's in
   float32);
7. measures the pinned host->device copy rate and the device-to-device
   copy rate and small-copy latency (the anchors of ``h100_host_path``
   and ``h100_d2d_path``, ``repro_torch/benchmarks/common.py``);
8. serve phases, each through ``repro_torch.launch.serve.main``:
   full-width qwen2-0.5b (8 requests of 12 tokens on 4 slots) and
   full-width recurrentgemma-2b (8 requests of 2100 tokens on 4 slots,
   max_len 2304, so its 2048-row ring cache wraps), bf16, random weights
   from the seed; each without paging, then with KV paging over xdma,
   then paged with ``--no-overlap``; the three runs' outputs must be
   equal, every request must install through the fused path, and the
   paged run must launch the page kernels and the flash kernel (the
   hybrid also rg_lru).  Then the capacity modes, paged: qwen2-0.5b with
   ``--kv-codec bf16`` (the unpaged tokens), ``--kv-codec int8`` fused
   and ``--no-fused-install`` (equal tokens) and ``--prefix-share`` (the
   tokens of the unpaged engine on the same prompts); the hybrid with
   ``--kv-codec int8`` (fused and unfused) and ``--prefix-share``.  Each
   prints tok/s, TTFT, the spilled bytes' compression ratio and the H2D
   bytes saved; fused runs must launch pack and install.  The access
   paths, paged: qwen2-0.5b over ``qdma``, ``verbs`` and ``auto`` and the
   hybrid over ``auto`` must give the xdma paged run's tokens (each
   ``[serve]`` line prints its path, and ``auto`` the pages each member
   took); then a dirty round trip through a verbs-backed ``TieredStore``
   of qwen2-0.5b pages: pages updated on the card, evicted dirty, read
   back byte-equal, ``c2h_bytes`` = dirty pages x page size;
9. bench phase: ``repro_torch.benchmarks.run --quick`` on the card (the
   paper's channel, contention, completion, RDMA-analogue, far-memory,
   overlap and install benchmarks; far-memory's path-selection sweep and
   full-width qwen2-0.5b serves over every access path, with their JSON
   under ``chiprun_out/bench``), then the kernel tour
   (``repro_torch.examples.kernels``) and the serving example
   (full-width recurrentgemma-2b), each counted.  Every byte check of a
   round trip raises inside the modules; held here are install parity,
   overlap ``bit_exact``, ``all_match_model``, every access path giving
   the verbs run's tokens, clean evictions moving 0 bytes and dirty ones
   exactly their pages' bytes.  Speed ratios are printed, not held;
10. reference check: at the smoke size in float32, qwen2-0.5b's and
   recurrentgemma-2b's prefill logits on the card agree with the CPU's
   within 1e-4 (the hybrid prompt of 40 tokens overruns its window of
   32);

Every kernel launch count is zeroed just before each counted run (the
paged serves over every access path, the capacity serves, the Fig-8
sweep, the bench phase's benchmarks and examples) and read just after;
the ``kernels`` line sums them.  Last it prints the card line, the
``kernels`` JSON line (all five kernels) and the device JSON line.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak, 700 W limit
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SOURCES = ("page_install", "rg_lru", "flash_attention", "stream_copy")
PACK_SOURCE = "src/repro_torch/csrc/page_install.cu"


def device_time_ms(fn, calls: int = 20, repeats: int = 9,
                   warmup: int = 3) -> float:
    """Median device milliseconds per ``fn()`` call (CUDA events around
    ``calls`` back-to-back calls, behind a sleep kernel that holds the
    stream while the host enqueues them)."""
    from repro_torch.benchmarks.common import time_call
    return time_call(fn, repeats=repeats, warmup=warmup, calls=calls,
                     device="cuda") * 1e3


def ptxas_summary(log: str):
    """One line per bf16 flash kernel instance from ``ptxas -v``: its
    registers, spills and any performance warning."""
    import re
    out, dh, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"flash_attention_bf16_kernelILi(\d+)E", line)
        if "Compiling entry function" in line:
            dh = m.group(1) if m else None
        elif m and "C75" in line:
            out.append(f"[ptxas] flash bf16 dh={m.group(1)} WARNING "
                       f"{line.split('ptxas info    : ')[-1][:90]}")
        elif dh and "spill" in line:
            spill = line.strip()
        elif dh and "Used" in line:
            out.append(f"[ptxas] flash bf16 (TMA + wgmma) dh={dh}: "
                       f"{line.split(': ', 1)[-1].strip()}; {spill}")
            dh = None
    return out


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
    pi.pack_page.launches = 0
    page_k = pi.pack_page(layout, single)
    pack_launches = pi.pack_page.launches
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
    pi.install_pages.launches = 0
    got = pi.install_pages(layout, [b.clone() for b in base], entries, slots)
    install_launches = pi.install_pages.launches
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

    def host_us(fn, calls: int = 20) -> float:
        """Host microseconds per call: wall time to issue ``calls``
        back-to-back calls, the card synchronised before, not after."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    t = {
        "install_host_us": host_us(
            lambda: pi.install_pages(layout, leaves_t, entries, slots)),
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
             pack_launches_per_call=pack_launches,
             install_launches_per_call=install_launches,
             pack_bound_ms=2 * pb / HBM_BYTES_PER_S * 1e3,
             install_bound_ms=2 * pb * G / HBM_BYTES_PER_S * 1e3)
    print(f"[kernels] {arch} max_len={max_len} B={B} G={G} page={pb}B "
          f"pack: launches_per_call={pack_launches} "
          f"kernel_ms={t['pack_ms']:.5f} "
          f"plain_ms={t['pack_plain_ms']:.5f} "
          f"library_ms={t['pack_library_ms']:.5f} "
          f"bound_us={t['pack_bound_ms'] * 1e3:.3f} | "
          f"install: launches_per_call={install_launches} "
          f"kernel_ms={t['install_ms']:.6f} "
          f"host_us_per_call={t['install_host_us']:.2f} "
          f"plain_ms={t['install_plain_ms']:.5f} "
          f"library_ms={t['install_library_ms']:.5f} "
          f"bound_ms={t['install_bound_ms']:.6f} "
          f"share={t['install_bound_ms'] / t['install_ms']:.3f}", flush=True)
    assert install_launches == 1, install_launches
    return t


def rg_lru_phase(B: int, T: int, W: int, timed: bool = True,
                 h0: bool = True) -> dict:
    """Hold ``rg_lru_scan`` bit for bit against its plain float32 loop
    (both are sequential float32, each step one rounded multiply and one
    rounded add, in the same order) and, with ``timed``, time both."""
    import torch
    from repro_torch.device import sm_count
    from repro_torch.kernels import rg_lru as R

    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + W)
    a = 0.5 + 0.499 * torch.rand((B, T, W), generator=gen, device="cuda")
    b = torch.randn((B, T, W), generator=gen, device="cuda")
    h = torch.randn((B, W), generator=gen, device="cuda") if h0 else None
    got = R.rg_lru_scan(a, b, h)
    want = R.rg_lru_scan_torch(a, b, h)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()), "rg_lru_scan: non-finite"
    assert torch.equal(got, want), \
        f"rg_lru_scan {(B, T, W)} is not bit-equal to its plain version " \
        f"(max abs err {err})"
    n_sms = sm_count(a.device)
    pl = R.plan(B, T, W, n_sms)
    in_flight = R.n_ctas(pl, B, W) * pl.stages * R.stage_bytes(pl)
    plan = (f"ctas={R.n_ctas(pl, B, W)} tile={pl.tile} steps={pl.steps} "
            f"stages={pl.stages} in_flight={in_flight}B "
            f"route={'tma' if pl.tma else 'cp.async'}")
    if not timed:
        print(f"[rg_lru] check B={B} T={T} W={W} h0={h0} {plan} "
              f"bit_equal=True", flush=True)
        return {"err": err}
    t = {"err": err,
         "ms": device_time_ms(lambda: R.rg_lru_scan(a, b, h)),
         # the plain loop issues 2 T ops: one call, three repeats
         "plain_ms": device_time_ms(lambda: R.rg_lru_scan_torch(a, b, h),
                                    calls=1, repeats=3, warmup=1),
         # a, b read and h written once (12 B T W), h0 read once (4 B W);
         # the final state is h[:, -1], not a separate output
         "bound_ms": (12 * B * T * W + 4 * B * W) / HBM_BYTES_PER_S * 1e3}
    print(f"[rg_lru] B={B} T={T} W={W} {plan} bit_equal=True "
          f"kernel_ms={t['ms']:.5f} plain_ms={t['plain_ms']:.5f} "
          f"bound_ms={t['bound_ms']:.5f} "
          f"share={t['bound_ms'] / t['ms']:.3f}", flush=True)
    return t


def live_pairs(S: int, causal: bool, window) -> int:
    """(q, k) pairs that the mask keeps."""
    total = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo + 1
    return total


def _qkv(B, S, H, KV, dh, dtype, seed, layout="bshd"):
    """q, k, v in the reference's (B, S, heads, dh) layout, or with
    ``layout="bhsd"`` as (B, S, heads, dh) views of (B, heads, S, dh)
    tensors (read through their strides)."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if layout == "bhsd":
        return [torch.randn((B, n, S, dh), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for n in (H, KV, KV)]
    return [torch.randn((B, S, n, dh), generator=gen, device="cuda")
            .to(dtype) for n in (H, KV, KV)]


def block_rms_err(got, want, rows: int = 64) -> float:
    """The largest relative RMS error over blocks of ``rows`` q rows of
    one (batch, head): a k tile that a block skipped moves its RMS by
    several percent even where the max-error bar does not see it."""
    d = (got.float() - want.float()).transpose(1, 2)   # (B, H, S, dh)
    w = want.float().transpose(1, 2)
    worst = 0.0
    for r in range(0, d.shape[2], rows):
        num = d[:, :, r:r + rows].pow(2).mean(dim=(2, 3)).sqrt()
        den = w[:, :, r:r + rows].pow(2).mean(dim=(2, 3)).sqrt()
        worst = max(worst, float((num / den.clamp_min(1e-30)).max()))
    return worst


BLOCK_RMS_TOL = 1e-2


def flash_check(B, S, H, KV, dh, dtype, tol, plain_f32=False,
                layout="bshd", **kw) -> float:
    """Kernel against the plain version; returns the max abs error.  Held
    to ``tol`` elementwise (abs + rel) and to ``BLOCK_RMS_TOL`` on the
    relative RMS error of every 64-row block of a (batch, head).

    With ``plain_f32`` the plain version runs in float32 on the same
    (bf16-valued) inputs: in bf16 it rounds the scores to bf16 before its
    softmax, which at logit-cap scale (scores near 30, an ulp of 0.125)
    is itself off by more than the 2e-2 bar, while the kernel keeps its
    scores in float32."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(B, S, H, KV, dh, dtype, seed=S + H + dh, layout=layout)
    if kw.get("logit_cap"):
        q, k = 5.0 * q, 5.0 * k
    got = FA.flash_attention(q, k, v, **kw)
    plain_in = [x.float() for x in (q, k, v)] if plain_f32 else (q, k, v)
    want = FA.attention_chunked(*plain_in, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    blk = block_rms_err(got, want)
    note = ""
    if plain_f32 and kw.get("logit_cap"):
        # shown, not held: how far the bf16 plain version is off
        note = " vs_plain_bf16=%.3e" % float(
            (got.float() - FA.attention_chunked(q, k, v, **kw).float())
            .abs().max())
    print(f"[flash] check B={B} S={S} H={H} KV={KV} dh={dh} {dtype} "
          f"layout={layout} {kw} "
          f"plain={'float32' if plain_f32 else dtype} "
          f"max_abs_err={err:.3e} block_rms_err={blk:.3e}{note}", flush=True)
    assert bool(torch.isfinite(got).all()), "flash_attention: non-finite"
    assert not bool(bad.any()), f"flash_attention differs from its plain " \
                                f"version beyond {tol}: {err}"
    assert blk <= BLOCK_RMS_TOL, f"flash_attention: a 64-row block's " \
                                 f"relative RMS error {blk} > {BLOCK_RMS_TOL}"
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
          f"({t['bound_by']}) TFLOP/s={flops / t['ms'] / 1e9:.2f} "
          f"bound_share={t['bound_ms'] / t['ms']:.3f}", flush=True)
    return t


def flash_checks() -> None:
    """Correctness only: the float32 kernel (logit cap, bidirectional,
    ragged S, d_head 256 with a window) and the bf16 TMA + wgmma kernel
    (the qwen2-0.5b serve path's own 12-token prefill, ragged S,
    bidirectional, window, logit cap; then the hybrid prefill, d_head 128
    and 32, B=2 at d_head 256 with a window, and a (B, H, S, dh)-strided
    view)."""
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
    # the TMA + wgmma kernel at its serve shape and across its head widths,
    # batch and layouts, against the plain version in float32
    flash_check(1, 2100, 10, 1, 256, bf16, 2e-2, plain_f32=True, window=2048)
    flash_check(1, 2100, 8, 2, 128, bf16, 2e-2, plain_f32=True)
    flash_check(2, 700, 4, 1, 256, bf16, 2e-2, plain_f32=True, window=256)
    flash_check(1, 200, 4, 2, 32, bf16, 2e-2, plain_f32=True)
    flash_check(2, 300, 8, 2, 128, bf16, 2e-2, plain_f32=True, layout="bhsd")


def _copy_input(R: int, C: int, dtype, seed: int):
    """Seeded random bits as an (R, C) tensor of ``dtype`` on the card,
    with -0.0 and NaN payloads planted in float inputs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (R, C),
                                          dtype=np.int64).astype(np.int32))
    elif dtype == torch.bfloat16:
        bits = rng.integers(0, 2 ** 16, (R, C)).astype(np.uint16)
        bits.reshape(-1)[:3] = (0x8000, 0x7FBE, 0xFFC1)   # -0.0, NaNs
        a = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        bits = rng.integers(0, 2 ** 32, (R, C), dtype=np.uint64) \
            .astype(np.uint32)
        bits.reshape(-1)[:3] = (0x80000000, 0x7FC00123, 0xFF800001)
        a = torch.from_numpy(bits.view(np.int32)).view(torch.float32)
    return a.to("cuda")


def stream_copy_checks() -> int:
    """Hold ``stream_copy`` byte for byte against its input on the
    reference test's grid (tests/test_kernels.py) and the full Fig-8
    grid, in float32, bfloat16 and int32; returns the cells checked."""
    import torch
    from repro_torch.benchmarks import vmem_stream
    from repro_torch.kernels import streamcopy as SC

    grid = [(64, 128, 8, 1), (64, 128, 8, 2), (256, 256, 32, 4),
            (128, 128, 128, 2), (64, 256, 16, 3)]
    grid += [(512, vmem_stream.COLS, br, nb) for br in vmem_stream.BLOCK_ROWS
             for nb in vmem_stream.BUFFERS]
    n = 0
    for R, C, br, nb in grid:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            x = _copy_input(R, C, dt, seed=R + C + br + nb)
            y = SC.stream_copy(x, block_rows=br, n_buffers=nb)
            torch.cuda.synchronize()
            assert torch.equal(y.view(torch.uint8), x.view(torch.uint8)), \
                f"stream_copy {(R, C, br, nb, dt)}: bytes differ"
            n += 1
    print(f"[stream_copy] {n} cells byte-equal to their input (reference "
          f"grid + Fig-8 grid, float32/bfloat16/int32, -0.0 and NaN "
          f"payloads planted)", flush=True)
    return n


def stream_copy_phase(R: int, C: int, cells) -> dict:
    """Time ``stream_copy`` at each (block_rows, n_buffers) of ``cells``
    on an (R, C) float32 input, beside its plain version (``clone``) and
    ``copy_`` into a preallocated tensor (a yardstick the port never
    calls); returns the numbers of the first cell."""
    import torch
    from repro_torch.device import sm_count
    from repro_torch.kernels import streamcopy as SC

    x = _copy_input(R, C, torch.float32, seed=R)
    dst = torch.empty_like(x)
    nbytes = x.numel() * 4
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    plain = device_time_ms(lambda: SC.stream_copy_torch(x))
    lib = device_time_ms(lambda: dst.copy_(x))
    out = None
    for br, nb in cells:
        y = SC.stream_copy(x, block_rows=br, n_buffers=nb)
        err = int((y.view(torch.uint8).to(torch.int16)
                   - x.view(torch.uint8).to(torch.int16)).abs().max())
        assert err == 0, f"stream_copy differs from its input: {err}"
        del y
        ms = device_time_ms(lambda: SC.stream_copy(x, block_rows=br,
                                                   n_buffers=nb))
        ctas, slice_bytes = SC.plan(br * C * 4, nb, sm_count(x.device))
        print(f"[stream_copy] ({R}, {C}) float32 {nbytes / 2 ** 20:.0f} MiB "
              f"block_rows={br} n_buffers={nb} ctas={ctas} "
              f"slice={slice_bytes}B kernel_ms={ms:.5f} "
              f"plain_ms={plain:.5f} copy__ms={lib:.5f} "
              f"bound_ms={bound:.5f} share={bound / ms:.3f} "
              f"(copy_ {bound / lib:.3f})", flush=True)
        if out is None:
            out = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "err": float(err),
                   "bound_ms": bound, "shape": [R, C], "block_rows": br,
                   "n_buffers": nb}
    return out


def codec_decode_check() -> None:
    """Device-side ``PageCodec.decode_row`` bytes equal numpy ``decode``
    for int8 and bf16, at both archs' serve layouts (bf16 caches) and at
    qwen2-0.5b's layout in float32 (where bf16 casts and int8 quantizes
    float32 leaves)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import page_codec_for

    cases = [("qwen2-0.5b", 128, None), ("recurrentgemma-2b", 2304, None),
             ("qwen2-0.5b", 128, "float32")]
    for arch, max_len, dt in cases:
        cfg = get_config(arch)
        if dt:
            cfg = dataclasses.replace(cfg, dtype=dt)
        layout = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                                T.init_cache(cfg, 2, max_len, "meta"), 2)
        rng = np.random.default_rng(max_len)
        parts = []
        for sp in layout.leaves:
            if sp.dtype in ("float32", "bfloat16", "float16"):
                v = rng.standard_normal(sp.nbytes // sp.itemsize) \
                    .astype(np.float32)
                if sp.dtype == "bfloat16":
                    v = (v.view(np.uint32) >> 16).astype(np.uint16)
                elif sp.dtype == "float16":
                    v = v.astype(np.float16)
            else:
                v = rng.integers(0, 256, sp.nbytes).astype(np.uint8)
            parts.append(v.view(np.uint8))
        page = np.concatenate(parts)
        for name in ("int8", "bf16"):
            codec = page_codec_for(cfg, max_len, name)
            enc = np.stack([codec.encode(page), codec.encode(page[::-1])])
            got = codec.decode_row(torch.from_numpy(enc).to("cuda")).cpu()
            for g in range(2):
                want = codec.decode(enc[g])
                assert np.array_equal(got[g].numpy(), want), \
                    f"{arch} {name}: device decode differs"
            print(f"[codec] {arch} {cfg.dtype} max_len={max_len} {name}: "
                  f"{layout.page_bytes} -> {codec.encoded_bytes} bytes, "
                  f"device decode byte-equal to numpy", flush=True)


def _counters():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import page_install as pi
    from repro_torch.kernels import rg_lru as R
    from repro_torch.kernels import streamcopy as SC
    return {"pack_page": pi.pack_page, "install_pages": pi.install_pages,
            "flash_attention": FA.flash_attention,
            "rg_lru_scan": R.rg_lru_scan, "stream_copy": SC.stream_copy}


# launches summed over every counted run of a path (each from 0)
LAUNCHES = {}


def counted(run):
    """Run ``run()`` with every kernel launch count zeroed just before
    and read just after; the counts are added to ``LAUNCHES`` and
    returned with the result."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    res = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
    return res, launches


def serve_phase(arch: str, flags, vocab: int, needs) -> dict:
    """Serve ``arch`` without paging, with paging (counted) and paged
    with ``--no-overlap``; the three must give the same outputs, and the
    kernels of ``needs`` must have launched in the paged run."""
    from repro_torch.launch import serve

    common = ["--arch", arch, "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda"] + list(flags)
    paged = common + ["--kv-paging", "--access-path", "xdma"]
    # the run without paging goes first: it also takes the process's
    # first-use costs (cuBLAS handles, allocator growth) off the paged run
    plain = serve.main(common)
    res, launches = counted(lambda: serve.main(paged))
    lat = res["latency"]
    print(f"[serve] {arch} launches={launches} install={res['install']} "
          f"tok_per_s={res['tok_per_s']:.2f} "
          f"ttft_p50_ms={lat['ttft_s']['p50'] * 1e3:.2f} "
          f"tpot_p50_ms={lat['tpot_s']['p50'] * 1e3:.2f} "
          f"h2c={res['kv']['h2c_bytes']} | unpaged "
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


def access_serve_phase(arch: str, flags, base: dict, paths) -> dict:
    """Serve ``arch`` paged over each access path of ``paths`` (qdma,
    verbs, auto), every run counted: the tokens must equal ``base``'s
    (the xdma paged run's), every request must install through the
    fused path, and the page kernels must launch.  The ``[serve]`` line
    prints the path and, for ``auto``, the pages each member took."""
    from repro_torch.launch import serve

    common = ["--arch", arch, "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda"] + list(flags)
    out = {}
    for path in paths:
        res, launches = counted(lambda: serve.main(
            common + ["--kv-paging", "--access-path", path]))
        kv, lat = res["kv"], res["latency"]
        cold = kv["cold"]
        extra = ""
        if path == "auto":
            extra = (f" placement={cold['placement']} "
                     f"decisions={len(res['path_decisions'])}")
        elif path == "verbs":
            extra = (f" doorbells={cold['qp']['doorbells']} staged_hops="
                     f"{sum(n['staged_hops'] for n in cold['nodes'])} "
                     f"coalesced_runs="
                     f"{sum(n['coalesced_runs'] for n in cold['nodes'])}")
        elif path == "qdma":
            extra = f" queues={cold['queues']}"
        print(f"[serve] {arch} path={path} launches={launches} "
              f"install={res['install']} "
              f"tok_per_s={res['tok_per_s']:.2f} "
              f"ttft_p50_ms={lat['ttft_s']['p50'] * 1e3:.2f} "
              f"tpot_p50_ms={lat['tpot_s']['p50'] * 1e3:.2f} "
              f"h2c={kv['h2c_bytes']} c2h={kv['c2h_bytes']}{extra}",
              flush=True)
        assert res["access_path"] == path and cold["path"] == path
        assert res["requests"] == 8 and res["undrained"] == 0, res
        assert res["install"]["fused"] == 8, res["install"]
        assert launches["pack_page"] > 0 and \
            launches["install_pages"] > 0, launches
        assert res["outputs"] == base["outputs"], \
            f"{arch}: --access-path {path} changed the tokens"
        if path == "auto":
            assert sum(cold["placement"].values()) >= 1, cold["placement"]
        out[path] = {"tok_per_s": res["tok_per_s"],
                     "ttft_p50_ms": lat["ttft_s"]["p50"] * 1e3}
    return out


def dirty_round_trip(arch: str = "qwen2-0.5b", max_len: int = 128) -> dict:
    """A verbs-backed ``TieredStore`` of ``arch``'s KV pages on the card:
    two resident pages updated on the device (``update_pages``), forced
    out by two other pages (dirty evictions: C2H, then verbs writes),
    read back byte-equal from the cold tier and from a slot;
    ``c2h_bytes`` must be the dirty pages times the page size."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T
    from repro_torch.rmem import TieredStore

    cfg = get_config(arch)
    pb = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                        T.init_cache(cfg, 2, max_len, "meta"), 2).page_bytes
    rng = np.random.default_rng(pb)
    old = rng.integers(0, 256, (4, pb), dtype=np.uint8)
    new = rng.integers(0, 256, (2, pb), dtype=np.uint8)
    with TieredStore(4, (pb,), dtype="uint8", n_hot_slots=2, path="verbs",
                     n_channels=2, doorbell_batch=2, device="cuda") as st:
        for p in range(4):
            st.write_page(p, old[p])
        st.ensure([0, 1])
        st.update_pages({0: new[0], 1: new[1]})
        assert st.dirty_pages == [0, 1], st.dirty_pages
        st.ensure([2, 3])                   # evicts the two dirty pages
        back = [st.read_page(p) for p in (0, 1)]
        dev = st.ensure([0])[0]
        torch.cuda.synchronize()
        s = st.stats()
    for p in (0, 1):
        assert np.array_equal(back[p], new[p]), f"page {p} differs"
    assert torch.equal(dev.cpu(), torch.from_numpy(new[0]))
    assert s["dirty_evictions"] == 2, s["dirty_evictions"]
    assert s["c2h_bytes"] == 2 * pb, (s["c2h_bytes"], pb)
    print(f"[dirty] {arch} max_len={max_len} verbs page={pb}B: 2 pages "
          f"updated on the card, evicted dirty and read back byte-equal; "
          f"c2h_bytes={s['c2h_bytes']} (= 2 x page) "
          f"dirty_evictions={s['dirty_evictions']} "
          f"clean_evictions={s['clean_evictions']} "
          f"writeback_bytes_skipped={s['writeback_bytes_skipped']}",
          flush=True)
    return s


def shared_prompts_unpaged(arch: str, prompt_len: int, max_len: int):
    """Outputs of the unpaged engine on the CLI's ``--prefix-share``
    prompts (seed 0, 8 requests, 16 new tokens, 4 slots): sharing off."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config(arch)
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cuda")
    prompts, pfx_len = serve.draw_prompts(0, 8, prompt_len, cfg.vocab,
                                          prefix_share=True)
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=max_len,
                      device="cuda")
    for r, p in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=p, max_new=16, prefix_len=pfx_len))
    assert eng.run_until_drained() == 0
    eng.close()
    return {r.rid: list(r.out_tokens) for r in eng.done}


def codec_serve_phase(arch: str, flags, base: dict, modes,
                      prompt_len: int, max_len: int) -> dict:
    """Serve ``arch`` paged with each capacity mode of ``modes``
    (``bf16``, ``int8``, ``share``), every run counted.  Fused runs must
    launch the page kernels; ``bf16`` must give ``base``'s (the unpaged
    run's) tokens, ``int8`` the same tokens fused and with
    ``--no-fused-install``, ``share`` the tokens of sharing off."""
    from repro_torch.launch import serve

    common = ["--arch", arch, "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda", "--kv-paging",
              "--access-path", "xdma"] + list(flags)
    base_h2c = base["kv"]["h2c_bytes"]
    results = {}

    def run(mode, extra, fused=True):
        res, launches = counted(lambda: serve.main(common + extra))
        kv, lat = res["kv"], res["latency"]
        assert res["requests"] == 8 and res["undrained"] == 0, res
        if fused:
            assert launches["pack_page"] > 0 and \
                launches["install_pages"] > 0, launches
            assert res["install"]["fused"] == 8, res["install"]
        else:
            assert res["install"]["fallback"] == 8, res["install"]
        ratio = kv["spill_bytes_logical"] / kv["spill_bytes_physical"]
        print(f"[serve:{mode}] {arch} launches={launches} "
              f"tok_per_s={res['tok_per_s']:.2f} "
              f"ttft_p50_ms={lat['ttft_s']['p50'] * 1e3:.2f} "
              f"tpot_p50_ms={lat['tpot_s']['p50'] * 1e3:.2f} "
              f"spill_logical={kv['spill_bytes_logical']} "
              f"spill_physical={kv['spill_bytes_physical']} "
              f"spill_ratio={ratio:.4f} h2c={kv['h2c_bytes']} "
              f"h2c_saved={base_h2c - kv['h2c_bytes']} "
              f"shared_pages={kv['shared_pages']} "
              f"dedup_bytes_saved={kv['dedup_bytes_saved']}", flush=True)
        results[mode] = {"tok_per_s": res["tok_per_s"],
                         "ttft_p50_ms": lat["ttft_s"]["p50"] * 1e3,
                         "spill_ratio": ratio, "h2c": kv["h2c_bytes"]}
        return res

    if "bf16" in modes:
        res = run("kv-codec=bf16", ["--kv-codec", "bf16"])
        assert res["outputs"] == base["outputs"], \
            f"{arch}: --kv-codec bf16 changed the tokens"
    if "int8" in modes:
        fused = run("kv-codec=int8", ["--kv-codec", "int8"])
        unfused = run("kv-codec=int8 --no-fused-install",
                      ["--kv-codec", "int8", "--no-fused-install"],
                      fused=False)
        assert fused["outputs"] == unfused["outputs"], \
            f"{arch}: int8 fused and unfused tokens differ"
    if "share" in modes:
        res = run("prefix-share", ["--prefix-share"])
        assert res["kv"]["shared_pages"] >= 1 and \
            res["kv"]["dedup_bytes_saved"] > 0, res["kv"]
        assert res["outputs"] == shared_prompts_unpaged(
            arch, prompt_len, max_len), \
            f"{arch}: --prefix-share changed the tokens"
    return results


def bench_phase() -> dict:
    """This slice's path: ``repro_torch.benchmarks.run --quick`` on the
    card (every module; far-memory's path-selection sweep and serves and
    the install bench with their JSON written under ``chiprun_out/bench``),
    then the kernel tour and the serving example, each run counted.  Any
    module that raises (every byte check of a round trip raises) exits
    non-zero.  Held here: install parity, overlap ``bit_exact``,
    ``all_match_model``, every access path giving the verbs run's tokens,
    clean evictions moving 0 bytes and a dirty eviction writing exactly
    the dirty pages' bytes.  Speed ratios (the reference's 1.5x install
    gate, overlap ``ok``) are printed, not held."""
    from repro_torch.benchmarks import far_memory
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import kernels as tour
    from repro_torch.examples import serve_requests

    out = os.path.join(ROOT, "chiprun_out", "bench")
    os.makedirs(out, exist_ok=True)
    res, launches = counted(lambda: bench_run.main(
        ["--quick", "--device", "cuda",
         "--json", os.path.join(out, "BENCH_miss_pipeline.json"),
         "--select-json", os.path.join(out, "BENCH_path_select.json"),
         "--install-json", os.path.join(out, "BENCH_install_path.json")]))
    print(f"[bench] benchmarks.run --quick launches={launches}", flush=True)
    assert all(launches[n] > 0 for n in ("pack_page", "install_pages",
                                         "flash_attention", "stream_copy")), \
        launches
    gate = res["install_path"]["gate"]
    assert gate["parity"] is True, gate
    ov = res["serve_overlap"]["overlap"]
    assert ov["bit_exact"] is True and ov["undrained"] == 0, ov
    fm = res["farmem_tier_sweep"]
    assert fm["path_select"]["all_match_model"] is True, fm["path_select"]
    serve = fm["serve"]
    assert serve["auto_bit_exact"] is True, serve
    for r in fm["dirty_sweep"]:
        dirty = r["evictions"] - r["clean_evictions"]
        assert dirty == round(r["dirty_ratio"] * r["evictions"]), r
        assert r["writeback_bytes"] == r["c2h_bytes"] == \
            dirty * far_memory.DIRTY_PAGE_BYTES, r
    print(f"[bench] held: install parity, overlap bit_exact, "
          f"all_match_model, every path gives verbs' tokens, "
          f"{len(fm['dirty_sweep'])} eviction rows (clean 0 B, dirty = "
          f"pages x {far_memory.DIRTY_PAGE_BYTES} B)", flush=True)
    print(f"[bench] not held: install depth4_speedup="
          f"{gate['depth4_speedup']:.2f}x (reference gate 1.5x) "
          f"overlap speedup={ov['speedup']:.2f}x ok={ov['ok']} "
          f"miss speedups=" + ",".join(
              f"{r['backend']}/db{r['doorbell']}:{r['speedup']:.2f}x"
              for r in fm["miss_pipeline"]["rows"]) +
          " serve tok_per_s=" + ",".join(
              f"{p}:{serve[p]['tok_per_s']:.1f}"
              for p in far_memory.PATH_NAMES + ("auto",)), flush=True)
    _, tl = counted(lambda: tour.main(["--device", "cuda"]))
    print(f"[bench] kernel tour launches={tl}", flush=True)
    assert all(tl[n] > 0 for n in ("flash_attention", "stream_copy",
                                   "rg_lru_scan")), tl
    outs, sl = counted(lambda: serve_requests.main(["--device", "cuda"]))
    print(f"[bench] serve_requests (full-width recurrentgemma-2b) "
          f"launches={sl}", flush=True)
    assert sorted(outs) == list(range(10)) and all(
        len(v) == 12 for v in outs.values()), outs
    assert sl["flash_attention"] > 0 and sl["rg_lru_scan"] > 0, sl
    return res


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
    from repro_torch.benchmarks.common import (card_line, d2d_copy_gbps,
                                               d2d_copy_latency_us,
                                               pinned_h2d_gbps)
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
    for line in ptxas_summary(build.BUILD_LOG.get("flash_attention",
                                                  (0, ""))[1]):
        print(line, flush=True)

    k128 = kernel_phase(128)
    kernel_phase(2048)
    kernel_phase(2304, arch="recurrentgemma-2b")
    lru = rg_lru_phase(1, 2100, 2560)
    rg_lru_phase(4, 2048, 2560)
    rg_lru_phase(2, 1001, 776, timed=False)               # ragged, TMA
    rg_lru_phase(2, 1001, 770, timed=False, h0=False)     # cp.async
    rg_lru_phase(1, 333, 130, timed=False, h0=False)      # cp.async
    flash_checks()
    fl = flash_phase(1, 2100, 10, 1, 256, window=2048)
    flash_phase(1, 2048, 14, 2, 64)
    flash_phase(1, 12, 14, 2, 64)   # the qwen2-0.5b serve path's prefill
    stream_copy_checks()
    from repro_torch.benchmarks import vmem_stream
    _, sweep = counted(lambda: vmem_stream.run(device="cuda"))
    print(f"[stream_copy] Fig-8 sweep launches={sweep}", flush=True)
    assert sweep["stream_copy"] > 0, sweep
    stream_copy_phase(512, 512, [(32, 2)])   # one Fig-8 cell, 1 MiB
    sc = stream_copy_phase(65536, 1024, [(1024, 2), (1024, 1), (1024, 4),
                                         (256, 2)])
    codec_decode_check()
    print(f"[h2d] pinned host->device 64 MiB: {pinned_h2d_gbps()} GB/s",
          flush=True)
    print(f"[d2d] copy_ on the card 256 MiB: {d2d_copy_gbps()} GB/s; "
          f"4 KiB copy_ + synchronize: {d2d_copy_latency_us()} us "
          f"(host)", flush=True)
    page_kernels = ("pack_page", "install_pages")
    qwen = serve_phase("qwen2-0.5b", [], 151936,
                       page_kernels + ("flash_attention",))
    access_serve_phase("qwen2-0.5b", [], qwen["result"],
                       ("qdma", "verbs", "auto"))
    codec_serve_phase("qwen2-0.5b", [], qwen["result"],
                      ("bf16", "int8", "share"), 12, 128)
    hybrid_flags = ["--prompt-len", "2100", "--max-len", "2304"]
    hybrid = serve_phase(
        "recurrentgemma-2b", hybrid_flags,
        256000, page_kernels + ("flash_attention", "rg_lru_scan"))
    access_serve_phase("recurrentgemma-2b", hybrid_flags, hybrid["result"],
                       ("auto",))
    codec_serve_phase("recurrentgemma-2b", hybrid_flags, hybrid["result"],
                      ("int8", "share"), 2100, 2304)
    dirty_round_trip()
    bench_phase()
    reference_check("qwen2-0.5b", 12, 32)
    reference_check("recurrentgemma-2b", 40, 64)

    # launches: summed over every counted run (the paged serves over
    # every access path, the codec and prefix-share serves, the Fig-8
    # sweep, the benchmarks and examples of the bench phase), each from 0
    launches = LAUNCHES
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
         "launches_per_call": k128["install_launches_per_call"],
         "host_us_per_call": k128["install_host_us"],
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
        {"name": "stream_copy", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_copy.cu",
         "replaces": "src/repro/kernels/streamcopy.py:24",
         "launches": launches["stream_copy"], "max_abs_err": sc["err"],
         "ms": sc["ms"], "plain_ms": sc["plain_ms"],
         "bound_ms": sc["bound_ms"], "bound_by": "bytes",
         "library_ms": sc["library_ms"],
         "shape": {"x": sc["shape"], "dtype": "float32",
                   "block_rows": sc["block_rows"],
                   "n_buffers": sc["n_buffers"]},
         "library_note": "Tensor.copy_ into a preallocated tensor"},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
