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
   2048), the recurrentgemma-2b layout (max_len 2304), the rwkv6-1.6b
   layout (max_len 384: float32 state beside bf16 token shifts) and
   qwen2-0.5b's with the int8 KV cache (max_len 128: int8 K/V beside
   float32 scales and int32 lengths), none of whose leaves may go to
   the install's fallback, B=4 slots, G=4 pages, random caches, holds
   ``pack_page`` and ``install_pages`` byte for byte against their
   plain PyTorch versions (an install whose slots repeat a slot
   included: the last page wins), prints both kernels'
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
   (S=2048, 14/2 heads, d_head 64, causal, bf16) and at the serve
   prefills (S=12) of qwen2-0.5b, qwen2-moe-a2.7b (16/16, d_head 128),
   qwen2-vl-7b (28/4, 128) and musicgen-large (32/32, 64), with TFLOP/s
   and the share of the bound; held against the plain version within
   2e-2 (bf16) and checked within 2e-5 (float32) at small shapes: logit
   cap, bidirectional, ragged S=12, d_head 256; the bf16 kernel also at
   the hybrid prefill, (1, 2100, 8/2, 128), B=2 at d_head 256 with a
   window, d_head 32 and a (B, H, S, dh)-strided view, and the other
   families' heads at S=12 and 300 (GQA groups 1, 7 and 6 at d_head
   128, grok's 48/8 with its logit cap of 30; MHA 32/32 at d_head 64),
   against the plain version in float32; every check
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
9. fabric phases. First pages written before a kill, read back: eight
   qwen2-0.5b pages (packed on the card) on a 4-member, 2-replica xdma
   fabric; ``FabricManager.kill`` repairs one member, each repaired copy
   is read from its new owner and every page through the survivor ring; a
   second member is marked failed and every page read again, failing over
   to its replicas (``failovers > 0``); all byte-equal, the failover batch
   installed on the card by ``install_pages`` byte-equal to the plain
   install. Then the serves, each counted: full-width qwen2-0.5b over a
   sharded KV plane (``--kv-shards 4 --kv-replicas 2 --kv-kill-node 5``)
   of xdma members, then of verbs members, and recurrentgemma-2b
   (2100-token prompts, max_len 2304) over ``--kv-shards 2 --kv-replicas 2
   --kv-kill-node 3`` of xdma members: the unpaged run's tokens, the kill
   landed with ``repair.lost == 0``, the page kernels launched (the
   hybrid's flash and rg_lru too); each ``[fabric]`` line prints TTFT and
   TPOT p50/p99 beside the single-path paged serve's, the repair's
   seconds, failovers and pages moved. Then the chaos serve: qwen2-0.5b
   over ``--kv-shards 3 --kv-replicas 2`` with ``--fault-seed 7
   --fault-rate 0.05 --fault-corrupt 0.2 --fault-flap 2:12`` against its
   fault-free baseline (equal tokens, nothing shed or undrained; the
   plan's counters and retry stats printed); then the qwen2-0.5b kill
   serve again with ``--trace-out`` (under ``chiprun_out/trace``) and
   ``--metrics``, its trace passing ``repro_torch.obs.validate`` with the
   serve, tier, fabric and path layers and the ``fabric.fail`` and
   ``serve.kill`` instants;
10. fleet phases (the serving frontend; qwen2-0.5b and
   recurrentgemma-2b cut to 6 layers at full width, ``CUT_LAYERS``),
   each serve counted and its
   ``[fleet]`` line printing TTFT, TPOT and queue-wait p50/p99, goodput
   in tokens per fleet virtual second and the rounds: full-width
   qwen2-0.5b (max_len 128) on ``--replicas 2 --tenants 2 --slots 2
   --arrivals burst``, 8 requests, paged over one shared xdma path, then
   the same with ``--kill-replica 2`` (requests re-routed, replica1
   killed), each with the tokens of one paged 2-slot engine serving the
   same ``Workload.requests``; the same fleet over a shared 3-member,
   2-replica fabric with ``--arrivals poisson:100``, calm and with
   ``--kv-kill-node 4 --kill-replica 8`` (equal tokens on the rids both
   serve, nothing lost); a 12-request burst on one replica, then under an
   SLO of the baseline's queue-wait p50 (every shed request without a
   token and with an ``slo`` reason, every served one with the
   baseline's tokens; the shed count and TTFT p99s printed, not held);
   full-width recurrentgemma-2b (max_len 512, 6 requests, 2 replicas,
   ``--kill-replica 3``) with one engine's tokens.  Pack, install and
   flash must launch, and rg_lru for the hybrid;
11. family phases (the other model families, ROADMAP A.5), each through
   ``serve_phase`` (unpaged, paged, ``--no-overlap``; equal tokens, 8
   fused installs, none on the fallback) at full width, bf16, seed 0, 8
   requests on 4 slots, 16 new tokens: qwen2-moe-a2.7b, qwen2-vl-7b and
   musicgen-large with 12-token prompts at max_len 128 (pack, install
   and flash must launch), rwkv6-1.6b with 256-token prompts (two
   128-token chunks) at max_len 384 (pack and install); qwen2-0.5b with
   the int8 KV cache (``kv_dtype="int8"``) through ``ServeEngine`` with
   the replaced config; each page's bytes held to the layout's
   (``FAMILY_SERVES``); grok-1-314b at smoke size only (628 GB of bf16
   weights fit no card), labelled reduced.  The three runs of a serve
   share one draw of its weights, freed before the next arch draws its
   own.  ``[family]`` lines print TTFT
   and TPOT p50/p99 of the three runs and the paged run's launches;
12. bench phase (the same cut of depth; a ``[time]`` line after each
   module): ``repro_torch.benchmarks.run --quick`` on the card (the
   paper's channel, contention, completion, RDMA-analogue, far-memory,
   overlap, fabric, chaos, serving-SLO, install and KV-capacity
   benchmarks; far-memory's
   path-selection sweep and full-width qwen2-0.5b serves over every
   access path, the full-width qwen2-0.5b serves of the chaos soak,
   ``serve_slo`` and ``kv_capacity``, with their JSON under
   ``chiprun_out/bench``), then the kernel tour
   (``repro_torch.examples.kernels``) and the serving example
   (full-width recurrentgemma-2b), each counted.  Every byte check of a
   round trip raises inside the modules; held here are install parity,
   overlap ``bit_exact``, ``all_match_model``, every access path giving
   the verbs run's tokens, clean evictions moving 0 bytes and dirty ones
   exactly their pages' bytes, the fabric sweep bit-exact with no page
   lost, the chaos soak bit-exact with its replicated cells shedding
   nothing, ``serve_slo``'s ``kill_bit_exact`` and ``kv_capacity``'s
   ``bitexact_bf16`` and ``bitexact_share``.  Speed and policy ratios
   (``ok_replicas``, ``ok_slo``, ``share_admit_uplift``) are printed,
   not held;
13. reference check: at the smoke size in float32, the logits of the
   prefill and of two greedy decode steps after it, of every served
   arch, on the card agree with the CPU's within 1e-4 (the hybrid
   prompt of 40 tokens overruns its window of 32; RWKV's of 256 tokens
   runs two chunks, its decode the T == 1 branch; qwen2-0.5b also with
   the int8 KV cache, whose decode quantises, stores and dequantises).
   A ``[time]`` line after each group of phases gives the seconds since
   the start;

Every kernel launch count is zeroed just before each counted run (the
paged serves over every access path, the capacity serves, the fabric,
chaos, trace, fleet and family serves, the Fig-8 sweep, the bench
phase's benchmarks and examples) and read just after;
the ``kernels`` line sums them, and gives the fleet serves' share as
``fleet_launches``.  Last it prints the card line, the
``kernels`` JSON line (all five kernels) and the device JSON line.
"""
from __future__ import annotations

import contextlib
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


def _rand_leaves(layout, gen, batch_shapes: bool):
    """Random cache leaves of ``layout`` on ``gen``'s device: one slot's
    (``batch_shapes`` false) or the whole batch's."""
    import torch
    from repro_torch.interop import torch_dtype
    out = []
    for sp in layout.leaves:
        shape = sp.batch_shape if batch_shapes else sp.shape
        dt = torch_dtype(sp.dtype)
        if dt.is_floating_point:
            out.append(torch.randn(shape, generator=gen, device=gen.device)
                       .to(dt))
        else:
            # every byte value of an int8 leaf, lengths up to 1000
            lo, hi = ((torch.iinfo(dt).min, torch.iinfo(dt).max + 1)
                      if dt.itemsize == 1 else (0, 1000))
            out.append(torch.randint(lo, hi, shape, generator=gen,
                                     device=gen.device, dtype=dt))
    return out


def kernel_phase(max_len: int, arch: str = "qwen2-0.5b", B: int = 4,
                 G: int = 4, **changes) -> dict:
    """Check both page kernels against their plain versions at ``arch``'s
    cache layout and time them; returns the numbers for the kernels
    line.  ``changes`` replace config fields (``kv_dtype="int8"``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import torch_dtype
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), **changes)
    dev = torch.device("cuda")
    layout = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                            T.init_cache(cfg, B, max_len, "meta"), B)
    assert not layout.fallback_indices(), layout.fallback_indices()
    gen = torch.Generator(device=dev)
    gen.manual_seed(max_len)

    def rand_leaves(batch_shapes: bool):
        return _rand_leaves(layout, gen, batch_shapes)

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
    print(f"[kernels] {arch}{changes or ''} max_len={max_len} B={B} G={G} "
          f"page={pb}B leaves={sorted({sp.dtype for sp in layout.leaves})} "
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
    # the other families' prefill heads: GQA groups 1, 7 and 6 at d_head
    # 128 (qwen2-moe 16/16, qwen2-vl 28/4, grok 48/8 with its logit cap),
    # MHA at d_head 64 (musicgen 32/32); the serve's 12 rows and 300
    flash_check(1, 12, 16, 16, 128, bf16, 2e-2, plain_f32=True)
    flash_check(1, 12, 28, 4, 128, bf16, 2e-2, plain_f32=True)
    flash_check(1, 12, 32, 32, 64, bf16, 2e-2, plain_f32=True)
    flash_check(1, 12, 48, 8, 128, bf16, 2e-2, plain_f32=True,
                logit_cap=30.0)
    flash_check(1, 300, 28, 4, 128, bf16, 2e-2, plain_f32=True)
    flash_check(1, 300, 32, 32, 64, bf16, 2e-2, plain_f32=True)
    flash_check(1, 300, 48, 8, 128, bf16, 2e-2, plain_f32=True,
                logit_cap=30.0)


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


def free_card() -> None:
    """Return what the last run left to the allocator: an arch's weights
    take up to 28 GB (qwen2-moe-a2.7b)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(arch: str, flags, vocab: int, needs,
                label: str = "") -> dict:
    """Serve ``arch`` without paging, with paging (counted) and paged
    with ``--no-overlap``; the three must give the same outputs, and the
    kernels of ``needs`` must have launched in the paged run.  The three
    runs share one draw of the weights (the CLI's ``tree_init`` is
    wrapped for the phase), freed when the phase ends."""
    from repro_torch.launch import serve

    init = serve.T.tree_init
    drawn = []

    def tree_init_once(defs, cfg, seed, device):
        if not drawn:
            drawn.append(init(defs, cfg, seed, device))
        return drawn[0]

    serve.T.tree_init = tree_init_once
    try:
        return _serve_three(serve, arch, flags, vocab, needs, label)
    finally:
        serve.T.tree_init = init
        drawn.clear()
        free_card()


def _serve_three(serve, arch, flags, vocab, needs, label) -> dict:
    common = ["--arch", arch, "--requests", "8", "--slots", "4",
              "--max-new", "16", "--device", "cuda"] + list(flags)
    paged = common + ["--kv-paging", "--access-path", "xdma"]
    # the run without paging goes first: it also takes the process's
    # first-use costs (cuBLAS handles, allocator growth) off the paged run
    plain = serve.main(common)
    free_card()
    res, launches = counted(lambda: serve.main(paged))
    free_card()
    lat = res["latency"]
    arch = arch + label
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
    return {"result": res, "launches": launches, "plain": plain,
            "serial": serial}


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


def fabric_failover_round_trip(arch: str = "qwen2-0.5b", max_len: int = 128,
                               B: int = 4, n_pages: int = 8) -> dict:
    """Pages written before a kill, read back on the card.  ``n_pages`` of
    ``arch``'s KV pages, packed on the card by ``pack_page``, are written
    to a 4-member, 2-replica fabric of xdma paths.  ``FabricManager.kill``
    then repairs the member that is primary for the most pages: every
    copy the repair made is read from its new owner, and every page
    through the survivor ring.  A second member is marked failed without
    repair and every page is read again in one batch, its pages failing
    over to their replicas.  Each read must equal the written bytes; the
    failover batch is staged to the card through the fabric and installed
    by ``install_pages``, byte-equal to the plain install of the written
    pages."""
    import collections

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.fabric import FabricManager, create_fabric
    from repro_torch.kernels import page_install as pi
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    layout = pi.page_layout(T.init_cache(cfg, 1, max_len, "meta"),
                            T.init_cache(cfg, B, max_len, "meta"), B)
    pb = layout.page_bytes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n_pages)
    pages = torch.stack([pi.pack_page(layout, _rand_leaves(layout, gen,
                                                           False))
                         for _ in range(n_pages)])
    host = pages.cpu().numpy()
    every = list(range(n_pages))

    def busiest():
        return collections.Counter(fab.ring.owners(p)[0]
                                   for p in every).most_common(1)[0][0]

    fab = create_fabric(n_pages=n_pages, page_bytes=pb, shards=4,
                        replicas=2, member="xdma", device="cuda",
                        n_channels=2)
    try:
        fab.write_many(every, list(host))
        before = {p: set(fab.ring.owners(p)) for p in every}
        killed = busiest()
        rep = FabricManager(fab).kill(killed)
        copies = [(p, n) for p in every for n in fab.ring.owners(p)
                  if n not in before[p]]
        assert copies and len(copies) == rep["copies_executed"], \
            (copies, rep)
        for p, n in copies:
            assert np.array_equal(fab.member(n).read_many([p])[0],
                                  host[p]), f"repaired page {p} on {n}"
        assert np.array_equal(fab.read_many(every), host), \
            "a read through the survivor ring differs"
        down = busiest()
        fab.mark_failed(down)
        f0 = fab.failovers
        order = every[::-1]
        rows = fab.read_many(order)
        failovers = fab.failovers - f0
        assert failovers > 0, "no read failed over"
        assert np.array_equal(rows, host[order]), "a failover read differs"
        staged = fab.stage_h2c(rows).wait()
        base = _rand_leaves(layout, gen, True)
        pi.install_pages.launches = 0
        err = 0
        for g0 in range(0, n_pages, B):
            got = pi.install_pages(layout, [b.clone() for b in base],
                                   [(staged, g) for g in range(g0, g0 + B)],
                                   list(range(B)))
            want = pi.install_pages_torch(
                layout, [b.clone() for b in base],
                [(pages, order[g]) for g in range(g0, g0 + B)],
                list(range(B)))
            torch.cuda.synchronize()
            err = max([err] + [int((g.view(torch.uint8).int() -
                                    w.view(torch.uint8).int()).abs().max())
                               for g, w in zip(got, want)])
        launches = pi.install_pages.launches
    finally:
        fab.close()
    assert err == 0, f"install of the failover reads differs ({err})"
    assert launches == n_pages // B, launches
    print(f"[fabric-reads] {arch} max_len={max_len} page={pb}B "
          f"pages={n_pages} shards=4 replicas=2: killed {killed}, "
          f"{len(copies)} repaired copies read from their new owners and "
          f"every page through the survivor ring byte-equal "
          f"(repair_s={rep['seconds']:.6f}); {down} marked failed: "
          f"failovers={failovers}, every page byte-equal, installed on "
          f"the card by install_pages ({launches} launches) byte-equal "
          f"to the plain install", flush=True)
    return {"copies": len(copies), "failovers": failovers}


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


def _lat_line(res: dict) -> str:
    lat = res["latency"]
    return (f"ttft_p50_ms={lat['ttft_s']['p50'] * 1e3:.2f} "
            f"ttft_p99_ms={lat['ttft_s']['p99'] * 1e3:.2f} "
            f"tpot_p50_ms={lat['tpot_s']['p50'] * 1e3:.2f} "
            f"tpot_p99_ms={lat['tpot_s']['p99'] * 1e3:.2f}")


def fabric_kill_phase(arch: str, flags, base: dict, member: str,
                      shards: int, kill_step: int, needs,
                      extra=()) -> dict:
    """Serve ``arch`` over a ``shards``-member fabric of ``member``
    paths, two replicas, one member killed at ``kill_step`` (counted):
    the tokens must equal ``base``'s (the unpaged run's), the kill must
    land with nothing lost, and the kernels of ``needs`` must launch.
    Prints TTFT/TPOT p50/p99 beside the single-path paged serve's, the
    repair's seconds, failovers and pages moved."""
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--requests", "8", "--slots", "4",
            "--max-new", "16", "--device", "cuda", "--access-path", member,
            "--kv-shards", str(shards), "--kv-replicas", "2",
            "--kv-kill-node", str(kill_step)] + list(flags) + list(extra)
    res, launches = counted(lambda: serve.main(argv))
    fb = res["fabric"]
    rep = fb["repair"]
    print(f"[fabric] {arch} member={member} shards={shards} replicas=2 "
          f"kill_step={fb['kill_step']} killed={fb['killed']} "
          f"launches={launches} {_lat_line(res)} "
          f"repair_s={rep['seconds']:.6f} moved_pages={rep['moved_pages']} "
          f"pages_moved={fb['pages_moved']} lost={rep['lost']} "
          f"failovers={fb['failovers']} epoch={fb['epoch']} "
          f"tok_per_s={res['tok_per_s']:.2f} | single-path xdma "
          f"{_lat_line(base)}", flush=True)
    assert fb["killed"] is not None and fb["kill_step"] == kill_step, fb
    assert rep["lost"] == 0, rep
    assert res["requests"] == 8 and res["undrained"] == 0, res
    assert res["install"]["fused"] == 8, res["install"]
    assert all(launches[n] > 0 for n in needs), (needs, launches)
    assert res["outputs"] == base["outputs"], \
        f"{arch}: the fabric kill serve over {member} changed the tokens"
    return res


def chaos_phase(base: dict) -> dict:
    """Full-width qwen2-0.5b over a 3-member, 2-replica fabric under the
    seeded fault plan, against its fault-free baseline of the same
    topology (both counted): equal tokens, nothing shed or undrained;
    prints the plan's counters and the retry stats."""
    from repro_torch.launch import serve

    argv = ["--requests", "8", "--slots", "4", "--max-new", "16",
            "--device", "cuda", "--access-path", "xdma", "--kv-shards",
            "3", "--kv-replicas", "2"]
    clean, cl = counted(lambda: serve.main(argv))
    res, launches = counted(lambda: serve.main(
        argv + ["--fault-seed", "7", "--fault-rate", "0.05",
                "--fault-corrupt", "0.2", "--fault-flap", "2:12"]))
    f = res["faults"]
    print(f"[chaos] qwen2-0.5b shards=3 replicas=2 plan={f['plan']} "
          f"retry={f['retry']} flaps={f['flaps']} shed={res['shed']} "
          f"undrained={res['undrained']} "
          f"failovers={res['fabric']['failovers']} integrity_failures="
          f"{res['fabric']['integrity_failures']} launches={launches} "
          f"{_lat_line(res)} | fault-free {_lat_line(clean)}", flush=True)
    assert clean["outputs"] == base["outputs"], "fabric changed the tokens"
    assert res["outputs"] == clean["outputs"], "faults changed the tokens"
    assert res["shed"] == 0 and res["undrained"] == 0, res["faults"]
    assert launches["pack_page"] > 0 and launches["install_pages"] > 0
    return res


def trace_phase(base: dict) -> dict:
    """The qwen2-0.5b kill serve again with ``--trace-out`` and
    ``--metrics``: the trace must pass
    ``repro_torch.obs.validate.validate_trace`` with the serve, tier,
    fabric and path layers and the ``fabric.fail`` and ``serve.kill``
    instants.  Tracing and live metrics are switched off after."""
    from repro_torch import obs
    from repro_torch.obs.validate import validate_trace

    out = os.path.join(ROOT, "chiprun_out", "trace")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "serve_kill_trace.json")
    try:
        res = fabric_kill_phase("qwen2-0.5b", [], base, "xdma", 4, 5,
                                ("pack_page", "install_pages"),
                                extra=("--trace-out", path, "--metrics"))
    finally:
        obs.trace.disable()
        obs.metrics.disable_live()
    info = validate_trace(path, require_cats=("serve", "tier", "fabric",
                                              "path"),
                          require_instants=("fabric.fail", "serve.kill"))
    print(f"[trace] {os.path.relpath(path, ROOT)}: {info['events']} "
          f"events, {info['spans']} spans, layers={info['cats']}, "
          f"metrics={len(res['metrics'])} keys", flush=True)
    return info


# launches summed over the counted fleet serves (each from 0)
FLEET_LAUNCHES = {}

# the depth of the earlier slices' models in the fleet and bench phases
# (width unchanged), to keep the whole run within its time
CUT_LAYERS = {"qwen2-0.5b": 6, "recurrentgemma-2b": 6}
CUT_READERS = ("repro_torch.configs", "repro_torch.launch.serve",
               "repro_torch.benchmarks.overlap",
               "repro_torch.benchmarks.kv_capacity",
               "repro_torch.examples.serve_requests")


@contextlib.contextmanager
def cut_depth():
    """Inside, ``get_config`` gives the archs of ``CUT_LAYERS`` that many
    layers, in every module of ``CUT_READERS`` (the ones the fleet and
    bench phases build their models through)."""
    import dataclasses
    import importlib
    from repro_torch import configs

    full = configs.get_config

    def get_config(arch):
        cfg = full(arch)
        n = CUT_LAYERS.get(arch)
        return dataclasses.replace(cfg, n_layers=n) if n else cfg

    mods = [importlib.import_module(m) for m in CUT_READERS]
    saved = [m.get_config for m in mods]
    for m in mods:
        m.get_config = get_config
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.get_config = f


def _fleet_line(res: dict) -> str:
    lat, fl = res["latency"], res["fleet"]
    q = lat["queue_wait_s"]
    return (f"{_lat_line(res)} "
            f"queue_wait_p50_ms={q['p50'] * 1e3:.2f} "
            f"queue_wait_p99_ms={q['p99'] * 1e3:.2f} "
            f"goodput_tok_per_vs={fl['goodput_tok_per_vs']:.2f} "
            f"rounds={fl['rounds']} "
            f"virtual_s={fl['virtual_seconds']:.4f}")


def fleet_counted(run):
    res, launches = counted(run)
    for name, n in launches.items():
        FLEET_LAUNCHES[name] = FLEET_LAUNCHES.get(name, 0) + n
    return res, launches


def fleet_single_engine(arch: str, n: int, max_len: int, spec: str,
                        slots: int = 2, tenants: int = 2) -> dict:
    """Tokens of one paged xdma ``ServeEngine`` with ``slots`` slots on
    the fleet CLI's requests (the seed-0 ``Workload`` of ``tenants``
    tenants) and the CLI's weights (seed 0)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeEngine, Workload,
                                     default_tenants, parse_arrivals)

    cfg = get_config(arch)
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cuda")
    wl = Workload(parse_arrivals(spec), default_tenants(tenants, max_len),
                  max_len, seed=0)
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                      access_path="xdma", device="cuda")
    for _, req in wl.requests(wl.schedule(n), cfg.vocab):
        eng.submit(req)
    assert eng.run_until_drained() == 0
    eng.close()
    out = {r.rid: list(r.out_tokens) for r in eng.done if r.failed is None}
    assert sorted(out) == list(range(n)), sorted(out)
    del params, eng
    torch.cuda.empty_cache()
    return out


def fleet_serve(label: str, argv, single: dict, needs,
                n: int) -> dict:
    """One counted fleet serve through the CLI: every request served,
    nothing undrained, the single engine's tokens per request id, and the
    kernels of ``needs`` launched."""
    from repro_torch.launch import serve

    res, launches = fleet_counted(lambda: serve.main(argv))
    fl = res["fleet"]
    print(f"[fleet] {label} launches={launches} install={res['install']} "
          f"{_fleet_line(res)} rerouted={fl['rerouted']} "
          f"killed_replicas={fl['killed_replicas']} "
          f"routed={ {k: v['routed'] for k, v in fl['per_replica'].items()} }",
          flush=True)
    assert res["requests"] == n and res["undrained"] == 0, res["rejected"]
    assert all(launches[k] > 0 for k in needs), (needs, launches)
    if single is not None:
        assert res["outputs"] == single, \
            f"{label}: the fleet changed the tokens"
    return res


def fleet_slo_phase(n: int = 12) -> dict:
    """A ``n``-request burst on one replica (2 slots), then the same burst
    under an ``AdmissionController`` whose TTFT deadline is the
    baseline's queue-wait p50, both through ``FleetRouter`` as the CLI
    builds it.  Held: every shed request has no token and a reason
    starting ``slo``, every served one the baseline's tokens.  Printed,
    not held: the shed count and both TTFT p99s (timing)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (AdmissionController, FleetRouter,
                                     Workload, default_tenants,
                                     parse_arrivals)

    cfg = get_config("qwen2-0.5b")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cuda")
    out = {}
    for mode in ("baseline", "policy"):
        slo_s = None if mode == "baseline" else out["slo_s"]
        tenants = default_tenants(2, 128, slo_ttft_s=slo_s)
        wl = Workload(parse_arrivals("burst"), tenants, 128, seed=0)
        fr = FleetRouter.build(
            cfg, params, replicas=1, batch_slots=2, max_len=128,
            access_path="xdma", device="cuda",
            admission_factory=lambda: AdmissionController(
                slo_ttft_s=slo_s))
        _, launches = fleet_counted(lambda: fr.run_open_loop(
            wl.requests(wl.schedule(n), cfg.vocab)))
        done = fr.done_requests()
        st = fr.stats()
        q = fr.merged_hist("queue_wait_hist").summary()
        ttft = fr.merged_hist("ttft_hist").summary()
        tpot = fr.merged_hist("tpot_hist").summary()
        fr.close()
        served = {r.rid: list(r.out_tokens) for r in done
                  if r.failed is None}
        shed = [r for r in done if r.failed is not None]
        print(f"[fleet] slo {mode} qwen2-0.5b 1 replica {n} requests "
              f"slo_ms={None if slo_s is None else round(slo_s * 1e3, 3)} "
              f"served={len(served)} shed={len(shed)} launches={launches} "
              f"ttft_p50_ms={ttft['p50'] * 1e3:.2f} "
              f"ttft_p99_ms={ttft['p99'] * 1e3:.2f} "
              f"tpot_p50_ms={tpot['p50'] * 1e3:.2f} "
              f"tpot_p99_ms={tpot['p99'] * 1e3:.2f} "
              f"queue_wait_p50_ms={q['p50'] * 1e3:.2f} "
              f"queue_wait_p99_ms={q['p99'] * 1e3:.2f} "
              f"goodput_tok_per_vs={st['goodput_tok_per_vs']:.2f} "
              f"rounds={st['rounds']}", flush=True)
        assert len(served) + len(shed) == n and st["served"] == len(served)
        if mode == "baseline":
            assert not shed and sorted(served) == list(range(n)), shed
            out.update(base=served, slo_s=max(q["p50"], 1e-3),
                       base_ttft_p99=ttft["p99"])
        else:
            for r in shed:
                assert r.failed.startswith("slo") and r.out_tokens == [], \
                    (r.rid, r.failed, r.out_tokens)
            for rid, toks in served.items():
                assert toks == out["base"][rid], \
                    f"slo: request {rid} changed its tokens"
            out.update(shed=len(shed), policy_ttft_p99=ttft["p99"])
    del params
    torch.cuda.empty_cache()
    return out


def fleet_phases() -> None:
    """The serving frontend on the card, each fleet serve counted (run
    inside ``cut_depth``):
    full-width qwen2-0.5b (max_len 128, 2 slots a replica, 2 replicas, 2
    tenants, a burst of 8) against one paged engine with 2 slots; the
    same with ``--kill-replica 2``; the kill scenario of ``serve_slo``
    over a shared 3-member, 2-replica fabric, calm and then with
    ``--kv-kill-node 4 --kill-replica 8``; SLO shedding under a
    saturating burst; full-width recurrentgemma-2b (max_len 512, 6
    requests, ``--kill-replica 3``) against one engine."""
    page_kernels = PAGE_KERNELS
    qargs = ["--max-len", "128", "--slots", "2", "--replicas", "2",
             "--tenants", "2", "--requests", "8", "--device", "cuda",
             "--kv-paging"]
    single = fleet_single_engine("qwen2-0.5b", 8, 128, "burst")
    fleet_serve("qwen2-0.5b burst 2 replicas",
                qargs + ["--arrivals", "burst"], single,
                page_kernels + ("flash_attention",), 8)
    kill = fleet_serve("qwen2-0.5b burst 2 replicas --kill-replica 2",
                       qargs + ["--arrivals", "burst", "--kill-replica",
                                "2"], single, page_kernels, 8)
    assert kill["fleet"]["rerouted"] > 0, kill["fleet"]
    assert kill["fleet"]["killed_replicas"] == ["replica1"], kill["fleet"]
    fab = qargs + ["--arrivals", "poisson:100", "--kv-shards", "3",
                   "--kv-replicas", "2"]
    calm = fleet_serve("qwen2-0.5b poisson:100 fabric 3x2 calm", fab,
                       single, page_kernels, 8)
    hit = fleet_serve("qwen2-0.5b poisson:100 fabric 3x2 --kv-kill-node 4 "
                      "--kill-replica 8",
                      fab + ["--kv-kill-node", "4", "--kill-replica", "8"],
                      None, page_kernels, 8)
    common = set(calm["outputs"]) & set(hit["outputs"])
    assert common and all(calm["outputs"][k] == hit["outputs"][k]
                          for k in common), "fabric kill changed tokens"
    fb = hit["fabric"]
    print(f"[fleet] fabric kill: killed={fb['killed']} "
          f"kill_round={fb['kill_round']} lost={fb['repair']['lost']} "
          f"repair_s={fb['repair']['seconds']:.6f} "
          f"moved_pages={fb['repair']['moved_pages']} "
          f"failovers={fb['failovers']} epoch={fb['epoch']} "
          f"common={len(common)}", flush=True)
    assert fb["killed"] is not None and fb["repair"]["lost"] == 0, fb
    slo = fleet_slo_phase()
    print(f"[fleet] slo not held: shed={slo['shed']} ttft_p99_ms "
          f"baseline={slo['base_ttft_p99'] * 1e3:.2f} "
          f"policy={slo['policy_ttft_p99'] * 1e3:.2f}", flush=True)
    hsingle = fleet_single_engine("recurrentgemma-2b", 6, 512, "burst")
    fleet_serve("recurrentgemma-2b burst 2 replicas --kill-replica 3",
                ["--arch", "recurrentgemma-2b", "--max-len", "512",
                 "--slots", "2", "--replicas", "2", "--tenants", "2",
                 "--requests", "6", "--device", "cuda", "--kv-paging",
                 "--arrivals", "burst", "--kill-replica", "3"], hsingle,
                page_kernels + ("flash_attention", "rg_lru_scan"), 6)
    print(f"[fleet] launches over the fleet serves: {FLEET_LAUNCHES}",
          flush=True)


# the other model families at full width, bf16, seed 0: arch, CLI flags,
# vocab, the kernels the paged serve must launch, and the bytes of one
# request's page (the layout's; an RWKV page is its state, whatever the
# prompt length)
PAGE_KERNELS = ("pack_page", "install_pages")
FAMILY_SERVES = (
    ("qwen2-moe-a2.7b", [], 151936, PAGE_KERNELS + ("flash_attention",),
     25165920),
    ("qwen2-vl-7b", [], 152064, PAGE_KERNELS + ("flash_attention",),
     7340144),
    ("musicgen-large", [], 2048, PAGE_KERNELS + ("flash_attention",),
     50331840),
    # two 128-token chunks a prompt, so the state carry runs
    ("rwkv6-1.6b", ["--prompt-len", "256", "--max-len", "384"], 65536,
     PAGE_KERNELS, 12779520),
)
INT8_KV_PAGE_BYTES = 835680      # qwen2-0.5b, kv_dtype="int8", max_len 128


def _family_line(arch: str, ph: dict, page_bytes: int) -> None:
    res = ph["result"]
    print(f"[family] {arch} page_bytes={page_bytes} launches="
          f"{ph['launches']} | paged {_lat_line(res)} tok_per_s="
          f"{res['tok_per_s']:.2f} | unpaged {_lat_line(ph['plain'])} | "
          f"no-overlap {_lat_line(ph['serial'])}", flush=True)


def kv_int8_phase(n: int = 8, max_len: int = 128) -> dict:
    """qwen2-0.5b with ``kv_dtype="int8"`` (int8 K/V beside float32
    scales in the cache) through ``ServeEngine`` with the replaced config,
    as the reference reaches it (no CLI flag): the CLI's seeded 12-token
    prompts, 8 requests on 4 slots, 16 new tokens, unpaged, paged over
    xdma (counted) and paged without overlap; equal tokens, every install
    fused with none on the fallback, pack, install and flash launched."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), kv_dtype="int8")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cuda")
    prompts, _ = serve.draw_prompts(0, n, 12, cfg.vocab)

    def run(**kw):
        eng = ServeEngine(cfg, params, batch_slots=4, max_len=max_len,
                          device="cuda", **kw)
        t0 = time.perf_counter()
        for r, p in enumerate(prompts):
            eng.submit(Request(rid=r, prompt=p, max_new=16))
        undrained = eng.run_until_drained()
        dt = time.perf_counter() - t0
        eng.close()
        assert undrained == 0 and all(r.failed is None for r in eng.done)
        return {"outputs": {r.rid: list(r.out_tokens) for r in eng.done},
                "install": {"fused": eng.install_fused,
                            "fallback": eng.install_fallback},
                "page_bytes": eng._layout.page_bytes,
                "fallback_leaves": eng._layout.fallback_indices(),
                "tok_per_s": n * 16 / dt,
                "latency": {"ttft_s": eng.ttft_hist.summary(),
                            "tpot_s": eng.tpot_hist.summary()}}

    plain = run()
    res, launches = counted(lambda: run(access_path="xdma"))
    serial = run(access_path="xdma", overlap=False)
    ph = {"result": res, "launches": launches, "plain": plain,
          "serial": serial}
    _family_line("qwen2-0.5b+int8kv", ph, res["page_bytes"])
    assert res["page_bytes"] == INT8_KV_PAGE_BYTES, res["page_bytes"]
    assert not res["fallback_leaves"], res["fallback_leaves"]
    assert res["install"] == {"fused": n, "fallback": 0}, res["install"]
    assert all(launches[k] > 0 for k in PAGE_KERNELS + ("flash_attention",)
               ), launches
    assert sorted(res["outputs"]) == list(range(n)) and all(
        len(v) == 16 for v in res["outputs"].values())
    assert plain["outputs"] == res["outputs"] == serial["outputs"], \
        "int8 KV: outputs differ across unpaged, paged and no-overlap"
    del params
    free_card()
    return ph


def family_phases() -> dict:
    """The other model families (ROADMAP A.5) served at full width: each
    of ``FAMILY_SERVES`` through ``serve_phase`` (unpaged, paged,
    ``--no-overlap``: equal tokens, 8 fused installs, no fallback, the
    named kernels launched) with its page bytes held to the layout's; the
    int8 KV cache (``kv_int8_phase``); and grok-1-314b at smoke size only
    (628 GB of bf16 weights fit no card), labelled as reduced."""
    out = {}
    for arch, flags, vocab, needs, page_bytes in FAMILY_SERVES:
        ph = serve_phase(arch, flags, vocab, needs)
        _family_line(arch, ph, page_bytes)
        got = ph["result"]["kv"]["page_bytes"]
        assert got == page_bytes, (arch, got, page_bytes)
        out[arch] = ph
    out["qwen2-0.5b+int8kv"] = kv_int8_phase()
    label = " (reduced: smoke size)"
    ph = serve_phase("grok-1-314b", ["--smoke"], 256,
                     PAGE_KERNELS + ("flash_attention",), label=label)
    _family_line("grok-1-314b" + label, ph,
                 ph["result"]["kv"]["page_bytes"])
    out["grok-1-314b"] = ph
    return out


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
    runs = {mod: mod.run for _, mod in bench_run.MODULES}

    def timed(name, run):
        def go(**kw):
            try:
                return run(**kw)
            finally:
                lap(f"bench {name}")
        return go

    for name, mod in bench_run.MODULES:
        mod.run = timed(name, mod.run)
    try:
        res, launches = counted(lambda: bench_run.main(
        ["--quick", "--device", "cuda",
         "--json", os.path.join(out, "BENCH_miss_pipeline.json"),
         "--select-json", os.path.join(out, "BENCH_path_select.json"),
         "--install-json", os.path.join(out, "BENCH_install_path.json"),
         "--fabric-json", os.path.join(out, "BENCH_fabric.json"),
         "--chaos-json", os.path.join(out, "BENCH_chaos.json"),
         "--serve-slo-json", os.path.join(out, "BENCH_serve_slo.json"),
         "--kv-capacity-json", os.path.join(out,
                                            "BENCH_kv_capacity.json")]))
    finally:
        for mod, run in runs.items():
            mod.run = run
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
    fab = res["fabric_sweep"]["fabric"]
    assert fab["bit_exact"] is True and fab["failover"]["lost"] == 0, fab
    assert fab["ok_rebalance"] is True, fab["rebalance"]
    ch = res["chaos_soak"]["chaos"]
    assert ch["bit_exact"] is True, ch
    for r in ch["rows"]:
        assert r["served"] + r["shed"] == 8, r
        if r["replicas"] > 1:
            assert r["shed"] == 0, r
    slo = res["serve_slo"]
    assert slo["kill_bit_exact"] is True, slo
    kvc = res["kv_capacity"]["gate"]
    assert kvc["bitexact_bf16"] is True, kvc
    assert kvc["bitexact_share"] is True, kvc
    print(f"[bench] held: install parity, overlap bit_exact, "
          f"all_match_model, every path gives verbs' tokens, "
          f"{len(fm['dirty_sweep'])} eviction rows (clean 0 B, dirty = "
          f"pages x {far_memory.DIRTY_PAGE_BYTES} B), fabric bit_exact "
          f"with 0 pages lost and a moved fraction of "
          f"{fab['rebalance']['moved_fraction']:.3f}, chaos bit_exact "
          f"with the replicated cells shedding nothing, serve_slo "
          f"kill_bit_exact, kv_capacity bitexact_bf16 and bitexact_share",
          flush=True)
    print(f"[bench] serve_slo: ok_replicas={slo['ok_replicas']} "
          f"scaling_2_vs_1={slo['scaling_2_vs_1']:.3f}x "
          f"goodput_1={slo['goodput_1']:.2f} goodput_2="
          f"{slo['goodput_2']:.2f} tok/vs | ok_slo={slo['ok_slo']} "
          f"slo_ms={slo['slo_ms']:.2f} shed_slo={slo['shed_slo']} "
          f"ttft_p99_ms baseline={slo['baseline_ttft_p99_s'] * 1e3:.2f} "
          f"policy={slo['policy_ttft_p99_s'] * 1e3:.2f} | kill "
          f"rerouted={slo['rerouted']} ttft_p99_ms="
          f"{slo['kill_ttft_p99_s'] * 1e3:.2f} | kv_capacity "
          f"share_admit_uplift={kvc['share_admit_uplift']:.2f}x "
          f"int8_spill_ratio={kvc['int8_spill_ratio']:.3f} (not held)",
          flush=True)
    print(f"[bench] fabric: scaling_4_vs_1={fab['scaling_4_vs_1']:.3f}x "
          f"shards1_vs_baseline={fab['shards1_vs_baseline']:.3f} "
          f"failover repair_s={fab['failover']['repair_s']:.4f} "
          f"ok={fab['ok']} | chaos: injected={ch['total_injected']} "
          f"shed={ch['total_shed']} ok={ch['ok']} p99 inflation s="
          + ",".join(f"{r['cell']}:{r['p99_inflation_s']:.3f}"
                     for r in ch["rows"]), flush=True)
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


def reference_check(arch: str, prompt_len: int, max_len: int,
                    steps: int = 2, **changes) -> float:
    """Smoke-size float32 prefill, then ``steps`` greedy decode steps
    (the decode path: RWKV's T == 1 branch, the MoE's decode routing, the
    int8 KV cache's quantise, scatter and dequantise), on the card vs on
    the CPU: every step's logits agree within 1e-4.  Both devices decode
    the CPU's greedy tokens.  ``changes`` replace config fields
    (``kv_dtype="int8"``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.interop import tree_map
    from repro_torch.models import lm
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32", **changes)
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, prompt_len))
    prefill, decode = lm.make_prefill_step(cfg), lm.make_decode_step(cfg)
    state, logits = {}, {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                           device=dev)}
        caches, lg = prefill(p, batch, T.init_cache(cfg, 1, max_len, dev))
        state[dev] = (p, caches)
        logits[dev] = [lg.float().cpu()]
    for i in range(steps):
        nxt = int(torch.argmax(logits["cpu"][-1], dim=-1))
        for dev in ("cpu", "cuda"):
            p, caches = state[dev]
            batch = {"tokens": torch.full((1, 1), nxt, dtype=torch.int32,
                                          device=dev),
                     "pos": torch.full((1, 1), prompt_len + i,
                                       dtype=torch.int32, device=dev)}
            caches, lg = decode(p, batch, caches)
            state[dev] = (p, caches)
            logits[dev].append(lg.float().cpu())
    errs = [float((c - g).abs().max())
            for c, g in zip(logits["cpu"], logits["cuda"])]
    print(f"[reference] {arch}{changes or ''} smoke float32, logits cuda "
          f"vs cpu: prefill of {prompt_len} tokens max_abs_err="
          f"{errs[0]:.3e}, decode steps " +
          ", ".join(f"{e:.3e}" for e in errs[1:]), flush=True)
    assert all(bool(torch.isfinite(lg).all()) for lg in logits["cuda"])
    assert max(errs) < 1e-4, errs
    return max(errs)


T0 = time.perf_counter()


def lap(name: str) -> None:
    """Print the seconds since the script started, after ``name``."""
    print(f"[time] {name} done at {time.perf_counter() - T0:.1f}s",
          flush=True)


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
    # the families' layouts: float32 RWKV state beside bf16 shifts; int8
    # K/V beside float32 scales and int32 lengths
    kernel_phase(384, arch="rwkv6-1.6b")
    kernel_phase(128, kv_dtype="int8")
    lap("kernel phases")
    lru = rg_lru_phase(1, 2100, 2560)
    rg_lru_phase(4, 2048, 2560)
    rg_lru_phase(2, 1001, 776, timed=False)               # ragged, TMA
    rg_lru_phase(2, 1001, 770, timed=False, h0=False)     # cp.async
    rg_lru_phase(1, 333, 130, timed=False, h0=False)      # cp.async
    flash_checks()
    fl = flash_phase(1, 2100, 10, 1, 256, window=2048)
    flash_phase(1, 2048, 14, 2, 64)
    flash_phase(1, 12, 14, 2, 64)   # the qwen2-0.5b serve path's prefill
    # the other families' serve prefills (qwen2-moe, qwen2-vl, musicgen)
    flash_phase(1, 12, 16, 16, 128)
    flash_phase(1, 12, 28, 4, 128)
    flash_phase(1, 12, 32, 32, 64)
    lap("rg_lru and flash phases")
    stream_copy_checks()
    from repro_torch.benchmarks import vmem_stream
    _, sweep = counted(lambda: vmem_stream.run(device="cuda"))
    print(f"[stream_copy] Fig-8 sweep launches={sweep}", flush=True)
    assert sweep["stream_copy"] > 0, sweep
    stream_copy_phase(512, 512, [(32, 2)])   # one Fig-8 cell, 1 MiB
    sc = stream_copy_phase(65536, 1024, [(1024, 2), (1024, 1), (1024, 4),
                                         (256, 2)])
    codec_decode_check()
    lap("stream_copy phases")
    print(f"[h2d] pinned host->device 64 MiB: {pinned_h2d_gbps()} GB/s",
          flush=True)
    print(f"[d2d] copy_ on the card 256 MiB: {d2d_copy_gbps()} GB/s; "
          f"4 KiB copy_ + synchronize: {d2d_copy_latency_us()} us "
          f"(host)", flush=True)
    page_kernels = PAGE_KERNELS
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
    lap("qwen2-0.5b and recurrentgemma-2b serves")
    dirty_round_trip()
    fabric_failover_round_trip()
    unpaged = qwen["result"]            # the paged run's = unpaged tokens
    for member in ("xdma", "verbs"):
        fabric_kill_phase("qwen2-0.5b", [], unpaged, member, 4, 5,
                          page_kernels)
    fabric_kill_phase("recurrentgemma-2b", hybrid_flags, hybrid["result"],
                      "xdma", 2, 3,
                      page_kernels + ("flash_attention", "rg_lru_scan"))
    chaos_phase(unpaged)
    trace_phase(unpaged)
    lap("fabric, chaos and trace phases")
    with cut_depth():
        fleet_phases()
    lap("fleet phases")
    family_phases()
    lap("family phases")
    with cut_depth():
        bench_phase()
    lap("bench phase")
    reference_check("qwen2-0.5b", 12, 32)
    reference_check("recurrentgemma-2b", 40, 64)
    for arch in ("qwen2-moe-a2.7b", "grok-1-314b", "qwen2-vl-7b",
                 "musicgen-large"):
        reference_check(arch, 12, 32)
    reference_check("rwkv6-1.6b", 256, 320)     # two chunks of 128
    reference_check("qwen2-0.5b", 12, 32, kv_dtype="int8")
    lap("reference checks")

    # launches: summed over every counted run (the paged serves over
    # every access path, the codec and prefix-share serves, the fabric,
    # chaos, trace, fleet and family serves, the Fig-8 sweep, the
    # benchmarks and examples of the bench phase), each from 0
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
    for k in kernels:
        # the part of ``launches`` the fleet serves made
        k["fleet_launches"] = FLEET_LAUNCHES.get(k["name"], 0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
