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
   then the training route of both model kernels (ROADMAP A.6): the
   flash kernel's output and ``FlashAttention``'s gradients (the kernel
   forward, the PyTorch backward ``flash_attention_bwd``) against
   autograd through the float32 plain version on the card, in bf16 at
   qwen2-0.5b's train shape (8, 128, 14/2, 64), recurrentgemma-2b's
   (8, 128, 10/1, 256, window 2048), a
   window shorter than S (2, 300, 8/2, 128, window 64) and grok's 48/8
   x 128 with its cap of 30, within 2e-2, and in float32 at smoke size
   within 1e-4; ``RgLruScan``'s gradients (forward and reversed scan on
   the kernel) against autograd through ``rg_lru_scan_torch`` at (8,
   128, 2560), (2, 97, 130) with h0 and T = 1; the forward and the
   backward timed at qwen2-0.5b's train shape;
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
12. training phases, each through ``repro_torch.launch.train.main``
   at full width, bf16, seed 0, the synthetic corpus, batch 8 x 128
   tokens, lr 3e-3 (the CLI's defaults), counted: qwen2-0.5b for 20
   steps; qwen2-0.5b for 10 steps with ``--ckpt-every 10`` into a
   temporary directory under ``build/`` (the shard phase restores it,
   then deletes it), then a
   second run resuming from step 10 for 4 steps (every restored leaf's
   sha256 held to the manifest, the last checkpoint at step 14);
   qwen2-0.5b for 4 steps with ``--offload-optimizer`` (the engine moves
   2 x ``host_bytes`` a step, ``host_bytes`` = 8 B x params);
   recurrentgemma-2b for 10 steps.  Losses finite, ``failures == 0``,
   the plain runs' last loss below their first, and the launches a step
   of ``TRAIN_LAUNCHES``; each ``[train]`` line prints step time,
   tokens/s, the share 6 N tokens / step time of the dense bf16 peak and
   the peak device memory.  The allocator grows segments
   (``expandable_segments``) so the full-width optimizer's temporaries
   find room;
13. shard phase (ROADMAP A.7): a one-rank NCCL group on a ``FileStore``
   under ``build/`` and ``launch.mesh.make_dev_mesh(1, 1)``; one train
   step of ``lm.make_train_step(..., ctx=ShardCtx(mesh, TRAIN_RULES))``
   on DTensor state and batch placed by ``launch.specs.train_specs``,
   and one plain step from the same weights (seed 0) and batch (8 x 128
   tokens), each counted, for full-width qwen2-0.5b (24 layers, bf16,
   ``remat="block"``), recurrentgemma-2b cut to ``CUT_LAYERS``,
   rwkv6-1.6b cut to ``SHARD_RWKV_LAYERS`` (its time mix on the local
   heads' route, ``models/rwkv.py``) and qwen2-moe-a2.7b cut to
   ``SHARD_MOE_LAYERS`` (its global MoE on each rank's tokens and expert
   shard, ``models/moe.py``, ``remat="block"``) with their widths:
   |dloss| < 2e-4
   and the largest |dparam| over every leaf < 5e-3 (the reference's
   bars, ``tests/test_distributed.py``), the
   sharded step's flash and rg_lru launches the plain step's (48 flash
   for qwen2-0.5b); ``[shard]`` lines print losses, both differences,
   step ms and launches.  Then ``DevicePrefetcher(sharding=)`` delivers
   a batch as DTensors with the batcher's bytes, and ``restore(
   shardings=)`` puts the training phase's saved qwen2-0.5b train state
   (step 14) on the mesh from the abstract (meta) state, every leaf's
   sha256 the manifest's; last the
   C.4 kernel-route check:
   ``FlashAttention`` in bf16 with q and k at std 60, at qwen2-0.5b's
   and the hybrid's train shapes, its gradients finite and within 2e-2
   of the largest of autograd through the float32 plain version;
13b. cost phase (ROADMAP A.8): first the flash wrapper's host us a
   call (``benchmarks/flash_host.py``'s ``measure``), on a quiet host;
   then the dry run (``repro_torch.launch.dryrun.run_cell``) of
   qwen2-0.5b's ``train_4k`` and ``decode_32k`` cells on the (16, 16)
   production mesh, rank 0 of PyTorch's fake 256-rank group, in a
   subprocess that sees no card; meanwhile one train step of
   full-width qwen2-0.5b (bf16, ``remat="block"``, seed 0) at 8 x 128
   and at 2 x 4096 tokens, and of full-width recurrentgemma-2b cut to 3
   layers (2 x 2048) and qwen2-moe-a2.7b cut to 2 (2 x 1024), each
   counted on meta tensors by the dry run's ``trace_step`` and run on
   the card: the trace's argument bytes are the state and batch on the
   card, the card's ``FlopCounterMode`` total equals the trace's
   FLOPs, and the trace's argument + temp is within 5% of
   ``max_memory_allocated`` over a real step (peak stats reset just
   before; the real step counted, 48 flash launches at full depth,
   each kernel of a cut arch at least once); then the dry-run
   records' FLOPs, collectives by
   category, argument + temp and roofline terms (``[cost]`` lines), the
   train cell held to its hand counts: FLOPs within 10% of 1.18e14 a
   rank, argument 46,339,972 B, argument + temp within 2x of 20 GB;
   then the dry run's readers (ROADMAP A.9) over those records in a
   temporary folder, with a skipped ``long_500k`` record and a tagged
   copy: ``launch/recompute`` gives back the dry run's own
   ``modeled_bytes`` and ``roofline``, exactly, and ``launch/report``'s
   tables (printed on ``[cost] report`` lines) have one ok row a cell,
   its ``roofline_fraction`` at 3 places, the SKIP row, no row of the
   tagged copy, and the H100 constants on the hardware line;
14. bench phase (the same cut of depth; a ``[time]`` line after each
   module): ``repro_torch.benchmarks.run --quick`` on the card (the
   paper's channel, contention, completion, RDMA-analogue, Table 1
   offload-step, far-memory, overlap, fabric, chaos, serving-SLO,
   install, KV-capacity and end-to-end train-step benchmarks; far-memory's
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
15. reference check: at the smoke size in float32, the logits of the
   prefill and of two greedy decode steps after it, of every served
   arch, on the card agree with the CPU's within 1e-4 (the hybrid
   prompt of 40 tokens overruns its window of 32; RWKV's of 256 tokens
   runs two chunks, its decode the T == 1 branch; qwen2-0.5b also with
   the int8 KV cache, whose decode quantises, stores and dequantises).
   Then the training reference check: at the smoke size in float32
   (labelled reduced), every arch's loss and gradient leaves on one
   batch and two train steps, card vs CPU: every card gradient leaf
   nonzero and within 1e-3 of the CPU's, the losses within 1e-4.
   A ``[time]`` line after each group of phases gives the seconds since
   the start;

Every kernel launch count is zeroed just before each counted run (the
paged serves over every access path, the capacity serves, the fabric,
chaos, trace, fleet and family serves, the Fig-8 sweep, the bench
phase's benchmarks and examples) and read just after;
the ``kernels`` line sums them, and gives the fleet serves' share as
``fleet_launches``, the sharded steps' as ``shard_launches`` (a
``shard_runs`` line holds their numbers), the cost phase's real steps'
as ``cost_launches`` (a ``cost_runs`` line holds the phase's numbers;
flash also ``wrapper_host_us``) and the training runs' as
``train_launches`` (flash
also the train-shape forward and backward times; a
``train_runs`` line before it holds each training run's numbers).  Last it prints the card line, the
``kernels`` JSON line (all five kernels) and the device JSON line.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
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


# ---------------------------------------------------------------------------
# training (ROADMAP A.6)
# ---------------------------------------------------------------------------

def _grad_err(got, want) -> float:
    """max |got - want| over max |want|."""
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max().clamp_min(
        1e-30))


def flash_train_check(B, S, H, KV, dh, dtype, tol, **kw) -> dict:
    """The kernel's output and ``FlashAttention``'s gradients (the
    kernel forward, then ``flash_attention_bwd``, which rebuilds P from
    q and k) against autograd through the float32 plain version
    (``attention_chunked``) on the card, on the same inputs.  Held: o
    within ``tol`` (abs + rel), dq/dk/dv within ``tol`` of the largest
    gradient."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(B, S, H, KV, dh, dtype, seed=7 * S + H + dh)
    if kw.get("logit_cap"):
        q, k = 5.0 * q, 5.0 * k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + dh)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    o = FA._launch(q, k, v, kw.get("causal", True), kw.get("window"),
                   None, kw.get("logit_cap"))
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    want_o = FA.attention_chunked(qf, kf, vf, **kw)
    want = torch.autograd.grad(want_o, (qf, kf, vf), do.float())
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    got_o = FA.flash_attention(qg, kg, vg, **kw)
    assert got_o.grad_fn is not None, "flash under autograd: no grad_fn"
    got = torch.autograd.grad(got_o, (qg, kg, vg), do)
    torch.cuda.synchronize()
    want_o = want_o.detach()
    res = {"o_err": float((o.float() - want_o.float()).abs().max()),
           "grad_err": max(_grad_err(g, w) for g, w in zip(got, want))}
    print(f"[train-flash] B={B} S={S} H={H} KV={KV} dh={dh} {dtype} {kw} "
          f"o_err={res['o_err']:.3e} "
          f"dqkv_rel_err={res['grad_err']:.3e} (plain float32, autograd)",
          flush=True)
    bad = (o.float() - want_o.float()).abs() > tol + tol * \
        want_o.float().abs()
    assert not bool(bad.any()), res
    assert res["grad_err"] <= tol, res
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in got), "flash backward: zero or non-finite grads"
    return res


def flash_train_timing(B, S, H, KV, dh) -> dict:
    """bf16 at a train shape: the kernel forward and
    ``flash_attention_bwd`` (plain PyTorch), device ms."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    q, k, v = _qkv(B, S, H, KV, dh, torch.bfloat16, seed=3)
    do = torch.randn_like(q)
    pairs = live_pairs(S, True, None)
    elems = B * S * (H + 2 * KV) * dh
    fwd_bytes = 2 * elems + 2 * B * S * H * dh
    # backward: read q, k, v and do, write dq, dk, dv; five products
    # over the live pairs (S again, dP, dV, dQ, dK)
    bwd_bytes = 2 * (elems + B * S * H * dh) + 2 * elems
    bwd_flops = 10 * B * H * dh * pairs
    t = {"fwd_ms": device_time_ms(lambda: FA._launch(
            q, k, v, True, None, None, None)),
         "bwd_ms": device_time_ms(lambda: FA.flash_attention_bwd(
             q, k, v, do), calls=5, repeats=5),
         "bwd_bound_ms": max(bwd_flops / BF16_FLOPS,
                             bwd_bytes / HBM_BYTES_PER_S) * 1e3,
         "fwd_bound_ms": max(4 * B * H * dh * pairs / BF16_FLOPS,
                             fwd_bytes / HBM_BYTES_PER_S) * 1e3}
    print(f"[train-flash] timed bf16 B={B} S={S} H={H} KV={KV} dh={dh}: "
          f"forward {t['fwd_ms']:.5f} ms (bound {t['fwd_bound_ms']:.5f}); "
          f"backward (PyTorch) {t['bwd_ms']:.5f} ms (bound "
          f"{t['bwd_bound_ms']:.5f})",
          flush=True)
    return t


def rg_lru_train_check(B, T, W, h0: bool) -> float:
    """``RgLruScan``'s da/db/dh0 (the reversed scan on the kernel)
    against autograd through ``rg_lru_scan_torch`` on the card; returns
    the largest error over the largest gradient (held to 1e-6)."""
    import torch
    from repro_torch.kernels import rg_lru as R

    gen = torch.Generator(device="cuda")
    gen.manual_seed(T + W)
    a = 0.8 + 0.199 * torch.rand((B, T, W), generator=gen, device="cuda")
    b = torch.randn((B, T, W), generator=gen, device="cuda")
    hz = torch.randn((B, W), generator=gen, device="cuda") if h0 else None
    dh = torch.randn((B, T, W), generator=gen, device="cuda")
    ins = [a, b] + ([hz] if h0 else [])
    got_in = [x.clone().requires_grad_() for x in ins]
    want_in = [x.clone().requires_grad_() for x in ins]
    n0 = R.rg_lru_scan.launches
    got = torch.autograd.grad(R.rg_lru_scan(*got_in), got_in, dh)
    assert R.rg_lru_scan.launches - n0 == 2, "forward + reversed scan"
    want = torch.autograd.grad(R.rg_lru_scan_torch(*want_in), want_in, dh)
    err = max(_grad_err(g, w) for g, w in zip(got, want))
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    print(f"[train-rg_lru] backward B={B} T={T} W={W} h0={h0}: "
          f"rel_err={err:.3e} bit_equal={equal} (autograd through the "
          f"plain loop)", flush=True)
    assert err <= 1e-6, err
    return err


def train_kernel_checks() -> dict:
    """Flash (forward + backward) and rg_lru (backward) at the training
    shapes, then the flash timings at qwen2-0.5b's train shape."""
    import torch
    bf = torch.bfloat16
    errs = [flash_train_check(8, 128, 14, 2, 64, bf, 2e-2),
            flash_train_check(8, 128, 10, 1, 256, bf, 2e-2, window=2048),
            flash_train_check(2, 300, 8, 2, 128, bf, 2e-2, window=64),
            flash_train_check(1, 128, 48, 8, 128, bf, 2e-2, logit_cap=30.0),
            flash_train_check(2, 40, 4, 2, 16, torch.float32, 1e-4,
                              window=9, logit_cap=30.0),
            flash_train_check(2, 32, 4, 2, 16, torch.float32, 1e-4)]
    lru = [rg_lru_train_check(8, 128, 2560, False),
           rg_lru_train_check(2, 97, 130, True),
           rg_lru_train_check(3, 1, 64, True)]
    t = flash_train_timing(8, 128, 14, 2, 64)
    t.update(grad_err=max(e["grad_err"] for e in errs[:4]),
             rg_lru_bwd_err=max(lru))
    return t


STEP_TIMES = []          # (step, seconds) of the last training run
RESTORED = []            # (step, leaves) of each digest-checked restore
OFFLOADED = []           # (bytes moved, host_bytes) of each offload step


def _train_hooks():
    """Patch the training loop's monitor, checkpoint manager and
    offloaded optimizer with subclasses that record step times, check a
    restore's digests against its manifest, and count the bytes each
    offloaded step moves."""
    import json as _json
    from repro_torch.checkpoint import manager as M
    from repro_torch.launch import train as TR
    if getattr(TR, "_hooked", False):
        return TR

    class TimedMonitor(TR.StragglerMonitor):
        def record(self, step, seconds):
            STEP_TIMES.append((step, seconds))
            return super().record(step, seconds)

    class CheckedManager(TR.CheckpointManager):
        def restore(self, like, step=None, shardings=None):
            step, tree = super().restore(like, step, shardings)
            with open(os.path.join(self.dir, f"step_{step:010d}",
                                   "manifest.json")) as f:
                want = {e["name"]: e["sha256"]
                        for e in _json.load(f)["leaves"]}
            pairs = M._flatten_with_path(tree)
            for path, leaf in pairs:
                name = M._leaf_name(path)
                got = M._digest(M._host_bytes(leaf))
                assert got == want[name], (name, got, want[name])
            RESTORED.append((step, len(pairs)))
            return step, tree

    class CountedOffload(TR.HostOffloadedOptimizer):
        def step(self, params, grads, step_idx):
            before = self.engine.stats()["bytes_moved"]
            out = super().step(params, grads, step_idx)
            OFFLOADED.append((self.engine.stats()["bytes_moved"] - before,
                              self.host_bytes()))
            return out

    TR.StragglerMonitor = TimedMonitor
    TR.CheckpointManager = CheckedManager
    TR.HostOffloadedOptimizer = CountedOffload
    TR._hooked = True
    return TR


def n_params(arch: str) -> int:
    """The parameter count of ``arch``'s tree, from its defs."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models import transformer as T
    return sum(int(np.prod(d.shape))
               for d in tree_leaves(T.param_defs(get_config(arch))))


# flash and rg_lru launches a step at full width: every attention layer's
# forward plus its remat recompute; every recurrent layer's forward, the
# recompute of the 16 in remat groups (the 2 tail layers are not
# rematerialised, as in the reference) and its reversed gradient scan
TRAIN_LAUNCHES = {"qwen2-0.5b": {"flash_attention": 48, "rg_lru_scan": 0},
                  "recurrentgemma-2b": {"flash_attention": 16,
                                        "rg_lru_scan": 52}}
TRAIN_RUNS = []
TRAIN_LAUNCHES_TOTAL = {}  # launches of the counted training runs


def train_run(label: str, arch: str, argv, steps: int) -> dict:
    """``repro_torch.launch.train.main`` at full width, bf16, seed 0,
    counted: losses finite and falling, no failure, the launches a step
    of ``TRAIN_LAUNCHES``; prints step time (median of the steps after
    the first), tokens/s, the share of the card's dense bf16 peak
    (6 N tokens / step time) and the peak device memory."""
    import math
    import statistics
    import torch
    TR = _train_hooks()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    STEP_TIMES.clear()
    res, launches = counted(lambda: TR.main(
        ["--arch", arch, "--log-every", "5"] + argv))
    times = [t for _, t in STEP_TIMES]
    losses = res["losses"]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    assert res["failures"] == 0, res
    for name, n in launches.items():
        TRAIN_LAUNCHES_TOTAL[name] = TRAIN_LAUNCHES_TOTAL.get(name, 0) + n
    per_step = {k: launches[k] / steps for k in TRAIN_LAUNCHES[arch]}
    assert per_step == TRAIN_LAUNCHES[arch], (label, per_step)
    tokens = 8 * 128
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    n = n_params(arch)
    row = {"label": label, "arch": arch, "steps": steps,
           "first_loss": losses[0], "final_loss": losses[-1],
           "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
           "tok_per_s": tokens / step_s,
           "bf16_peak_share": 6 * n * tokens / step_s / BF16_FLOPS,
           "params": n, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step, "seconds": res["seconds"]}
    print(f"[train] {label} {arch} steps={steps} loss "
          f"{losses[0]:.4f}->{losses[-1]:.4f} step_ms={row['step_ms']:.1f} "
          f"(first {row['first_step_ms']:.1f}) tok/s={row['tok_per_s']:.0f} "
          f"6NT_share_of_bf16_peak={row['bf16_peak_share']:.4f} "
          f"params={n} peak_mem_GB={row['peak_gb']:.2f} "
          f"launches/step={per_step}", flush=True)
    TRAIN_RUNS.append(row)
    return row


def train_phases(d: str) -> None:
    """The four full-width runs: qwen2-0.5b plain (20 steps), with a
    checkpoint at step 10 and a resumed run to step 14 in ``d`` (whose
    step 14 the shard phase restores; ``main`` deletes ``d``), with the
    host-offloaded optimizer (4 steps); recurrentgemma-2b plain (10
    steps)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    q = "qwen2-0.5b"
    plain = train_run("plain", q, ["--steps", "20"], 20)
    assert plain["final_loss"] < plain["first_loss"], plain
    RESTORED.clear()
    first = train_run("ckpt", q, ["--steps", "10", "--ckpt-dir", d,
                                  "--ckpt-every", "10"], 10)
    resumed = train_run("resume", q, ["--steps", "4", "--ckpt-dir", d,
                                      "--ckpt-every", "10"], 4)
    mgr = CheckpointManager(d, device="cuda")
    steps = mgr.all_steps()
    mgr.close()
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f"step_{s:010d}", f))
                     for s in steps[-1:] for f in os.listdir(
                         os.path.join(d, f"step_{s:010d}")))
    print(f"[train] resume: restored={RESTORED} (every leaf's digest "
          f"held to the manifest) checkpoints={steps} "
          f"bytes_on_disk={ckpt_bytes} loss {first['first_loss']:.4f}"
          f"->{first['final_loss']:.4f} then "
          f"{resumed['first_loss']:.4f}->{resumed['final_loss']:.4f}",
          flush=True)
    assert RESTORED and RESTORED[0][0] == 10, RESTORED
    assert steps[-1] == 14, steps
    OFFLOADED.clear()
    off = train_run("offload", q, ["--steps", "4", "--offload-optimizer"],
                    4)
    moved = [b for b, _ in OFFLOADED]
    host = OFFLOADED[0][1]
    print(f"[train] offload: host_bytes={host} (8 B x {n_params(q)} "
          f"params) moved/step={moved}", flush=True)
    assert host == 8 * n_params(q), host
    assert all(b == 2 * host for b in moved), moved
    off["host_bytes"] = host
    hyb = train_run("plain", "recurrentgemma-2b", ["--steps", "10"], 10)
    assert hyb["final_loss"] < hyb["first_loss"], hyb
    free_card()


def train_reference_check(arch: str, steps: int = 2) -> dict:
    """Smoke size, float32, seed 0: loss and every gradient leaf of one
    batch, then ``steps`` train steps, on the card vs on the CPU.  Every
    card gradient leaf is nonzero and within 1e-3 of the CPU's (over
    the leaf's largest; float32 sums in another order, through the
    recurrence at worst); the losses of the steps within 1e-4; the
    params after them are printed (AdamW's first steps move a param by
    about lr times the sign of its gradient, so a gradient within
    rounding of zero moves it either way)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import for_arch

    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    opt = for_arch(arch, lr=1e-3, warmup_steps=1)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        (loss, _), grads = lm.value_and_grad(cfg, p, batch)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = lm.make_train_step(cfg, opt)
        losses = [float(loss)]
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[dev] = (losses, [g.cpu() for g in tree_leaves(grads)],
                    [t.cpu() for t in tree_leaves(state["params"])])
    loss_err = max(abs(a - b) for a, b in zip(out["cpu"][0],
                                              out["cuda"][0]))
    grad_err = max(_grad_err(g, c) for g, c in zip(out["cuda"][1],
                                                   out["cpu"][1]))
    param_err = max(_grad_err(g, c) for g, c in zip(out["cuda"][2],
                                                    out["cpu"][2]))
    zero = sum(float(g.abs().max()) == 0 for g in out["cuda"][1])
    print(f"[train-reference] {arch} smoke float32 (reduced), cuda vs cpu: "
          f"loss_err={loss_err:.3e} over {steps} steps, "
          f"grad_rel_err={grad_err:.3e} over {len(out['cuda'][1])} leaves "
          f"(zero leaves {zero}), params_rel_err={param_err:.3e}",
          flush=True)
    assert zero == 0, f"{arch}: {zero} gradient leaves are zero on the card"
    assert loss_err <= 1e-4 and grad_err <= 1e-3, \
        (arch, loss_err, grad_err, param_err)
    return {"loss_err": loss_err, "grad_err": grad_err}


# the bars of the sharded step against the plain one: the reference's
# (tests/test_distributed.py), the grad norm's relative bar in bf16
# (the one-rank steps have read up to 5.2e-3 apart), and the C.4
# kernel-route check's
SHARD_DLOSS, SHARD_DPARAM, SHARD_GNORM = 2e-4, 5e-3, 2e-2
C4_TOL = 2e-2
SHARD_RUNS = []
SHARD_LAUNCHES = {}      # launches of the counted sharded steps
# rwkv6-1.6b's depth in the shard phase, at its full widths: its time
# mix runs on the local heads' route (``models/rwkv.py``)
SHARD_RWKV_LAYERS = 6
# qwen2-moe-a2.7b's: its global MoE runs on each rank's tokens and
# expert shard (``models/moe.py``, ``_on_token_shards``)
SHARD_MOE_LAYERS = 2


def _timed(fn):
    """(fn(), host seconds) around a call that ends in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def shard_step_check(label: str, cfg, mesh, opt) -> dict:
    """One step of ``lm.make_train_step(cfg, opt, ctx=ShardCtx(mesh,
    TRAIN_RULES))`` on DTensor state and batch placed by
    ``train_specs``' shardings, and one plain step from the same weights
    (seed 0) and batch (8 x 128 tokens), each counted: |dloss| and the
    largest |dparam| over every leaf within the reference's bars, the
    grad norm within ``SHARD_GNORM`` of the plain step's, and
    the sharded step's flash and rg_lru launches those of the plain
    step (the kernels ran on the local shards, not the plain version).
    A second sharded step is timed too (DTensor caches its sharding
    decisions on the first).  Returns the abstract (meta) state and the
    shardings."""
    import torch
    from repro_torch.configs import ShapeCfg
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.specs import train_specs
    from repro_torch.launch.train import build_state
    from repro_torch.models import lm
    from repro_torch.sharding import (TRAIN_RULES, ShardCtx,
                                      distribute_tree, full)
    B, S = 8, 128
    state = build_state(cfg, opt, 0, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    cell, _ = train_specs(cfg, ShapeCfg("train", S, B, "train"), mesh, opt)
    ((plain, pm), plain_s), pl_launch = counted(lambda: _timed(
        lambda: lm.make_train_step(cfg, opt)(state, batch)))
    state_d = distribute_tree(state, cell.shardings[0], src_data_rank=None)
    batch_d = distribute_tree(batch, cell.shardings[1], src_data_rank=None)
    step = lm.make_train_step(cfg, opt, ctx=ShardCtx(mesh, TRAIN_RULES))
    ((new, sm), shard_s), sh_launch = counted(lambda: _timed(
        lambda: step(state_d, batch_d)))
    for name, n in sh_launch.items():
        SHARD_LAUNCHES[name] = SHARD_LAUNCHES.get(name, 0) + n
    _, again_s = _timed(lambda: step(new, batch_d))
    dloss = abs(float(sm["loss"]) - float(pm["loss"]))
    dparam = max(float((full(a).float() - b.float()).abs().max())
                 for a, b in zip(tree_leaves(new["params"]),
                                 tree_leaves(plain["params"])))
    kern = ("flash_attention", "rg_lru_scan")
    row = {"label": label, "arch": cfg.arch_id, "layers": cfg.n_layers,
           "loss": float(sm["loss"]), "plain_loss": float(pm["loss"]),
           "dloss": dloss, "dparam": dparam,
           "grad_norm": float(sm["grad_norm"]),
           "plain_grad_norm": float(pm["grad_norm"]),
           "step_ms": shard_s * 1e3, "second_step_ms": again_s * 1e3,
           "plain_step_ms": plain_s * 1e3,
           "launches": {k: sh_launch[k] for k in kern},
           "plain_launches": {k: pl_launch[k] for k in kern},
           "placements": sorted({str(p) for sh in tree_leaves(
               cell.shardings[0]) for p in sh[1]})}
    print(f"[shard] {label} {cfg.arch_id} layers={cfg.n_layers} mesh "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names}: loss "
          f"{row['loss']:.6f} (plain {row['plain_loss']:.6f}) "
          f"dloss={dloss:.3e} dparam={dparam:.3e} grad_norm "
          f"{row['grad_norm']:.6g} (plain {row['plain_grad_norm']:.6g}) "
          f"(bars {SHARD_DLOSS}, {SHARD_DPARAM}, {SHARD_GNORM} rel) "
          f"step_ms={row['step_ms']:.1f} (second "
          f"{row['second_step_ms']:.1f}; plain {row['plain_step_ms']:.1f}) "
          f"launches={row['launches']} plain={row['plain_launches']} "
          f"placements={row['placements']}", flush=True)
    assert dloss < SHARD_DLOSS and dparam < SHARD_DPARAM, row
    assert abs(row["grad_norm"] - row["plain_grad_norm"]) <= \
        SHARD_GNORM * row["plain_grad_norm"], row
    assert row["launches"] == row["plain_launches"], row
    SHARD_RUNS.append(row)
    return {"like": cell.abstract[0], "shardings": cell.shardings}


def shard_io_check(cfg, mesh, qwen: dict, ckpt_dir: str) -> None:
    """``DevicePrefetcher(sharding=)`` delivers a batch as DTensors on
    the card mesh, the batcher's bytes; ``restore(shardings=)`` puts the
    training phase's saved qwen2-0.5b train state (step 14, 4.94 GB) on
    the mesh from the abstract (meta) state, each rank's slice read on
    the host and moved alone, each leaf's sha256 the manifest's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import manager as M
    from repro_torch.data import pipeline as PP
    from repro_torch.interop import to_numpy
    spec = PP.BatchSpec(8, 128)
    want = PP.PackedBatcher(PP.SyntheticCorpus(cfg.vocab), spec)
    pre = PP.DevicePrefetcher(PP.PackedBatcher(PP.SyntheticCorpus(
        cfg.vocab), spec), sharding=qwen["shardings"][1], device="cuda")
    try:
        got, w = next(pre), want.next_batch()
    finally:
        pre.close()
    for k, v in w.items():
        assert isinstance(got[k], DTensor), k
        assert to_numpy(got[k].full_tensor().cpu()).tobytes() == \
            v.tobytes(), k
    print(f"[shard] prefetch: {sorted(got)} as DTensors "
          f"{[str(p) for p in got['tokens'].placements]} on "
          f"{got['tokens'].device}, the batcher's bytes", flush=True)
    mgr = M.CheckpointManager(ckpt_dir, device="cuda")
    (step, tree), restore_s = _timed(lambda: mgr.restore(
        qwen["like"], shardings=qwen["shardings"][0]))
    mgr.close()
    with open(os.path.join(ckpt_dir, f"step_{step:010d}",
                           "manifest.json")) as f:
        digests = {e["name"]: e["sha256"] for e in json.load(f)["leaves"]}
    pairs = M._flatten_with_path(tree)
    for path, leaf in pairs:
        name = M._leaf_name(path)
        assert isinstance(leaf, DTensor), name
        got_d = M._digest(M._host_bytes(leaf.full_tensor()))
        assert got_d == digests[name], (name, got_d, digests[name])
    assert len(pairs) == len(digests), (len(pairs), len(digests))
    print(f"[shard] restore(shardings=) onto the meta state: step {step}, "
          f"{len(pairs)} leaves as DTensors, every sha256 the manifest's; "
          f"restore {restore_s:.2f}s", flush=True)


def c4_kernel_check(B, S, H, KV, dh, **kw) -> float:
    """ROADMAP C.4 on the kernel route: ``FlashAttention`` on the card in
    bf16 with q and k at std 60 (scores of 10^3-10^4), its gradients
    against autograd through the float32 plain version on the same
    inputs; finite, within ``C4_TOL`` of the largest.  Returns the
    largest relative error."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda")
    gen.manual_seed(60 + dh)
    rnd = lambda std, *s: (std * torch.randn(
        s, generator=gen, device="cuda")).to(torch.bfloat16)
    q, k = rnd(60.0, B, S, H, dh), rnd(60.0, B, S, KV, dh)
    v, do = rnd(1.0, B, S, KV, dh), rnd(1.0, B, S, H, dh)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(FA.flash_attention(qg, kg, vg, **kw),
                              (qg, kg, vg), do)
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(FA.attention_chunked(qf, kf, vf, **kw),
                               (qf, kf, vf), do.float())
    err = max(_grad_err(g, w) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"[shard] C.4 kernel route: bf16 B={B} S={S} H={H} KV={KV} "
          f"dh={dh} {kw} q,k std 60: dqkv rel_err={err:.3e} (bar "
          f"{C4_TOL}, autograd through the float32 plain version) "
          f"finite={finite} largest |dq|={float(want[0].abs().max()):.1f}",
          flush=True)
    assert finite and err <= C4_TOL, err
    return err


def shard_phases(ckpt_dir: str) -> None:
    """The sharded train step on a one-rank NCCL group (a ``FileStore``
    under ``build/``, no network) and ``make_dev_mesh(1, 1)``:
    qwen2-0.5b at full width (24 layers), recurrentgemma-2b at
    ``CUT_LAYERS`` depth, rwkv6-1.6b at ``SHARD_RWKV_LAYERS`` and
    qwen2-moe-a2.7b at ``SHARD_MOE_LAYERS`` with
    their widths, the prefetcher's and the
    restore's placements (the restore from ``ckpt_dir``, the training
    phase's checkpoints), then the C.4 kernel-route check."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.optim.adamw import AdamW
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="shard_store_", dir=os.path.join(ROOT,
                                                                 "build"))
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_dev_mesh(1, 1)
        opt = AdamW(lr=3e-3, warmup_steps=5, decay_steps=10)
        qcfg = get_config("qwen2-0.5b")
        qwen = shard_step_check("full", qcfg, mesh, opt)
        assert SHARD_RUNS[-1]["launches"]["flash_attention"] == \
            TRAIN_LAUNCHES["qwen2-0.5b"]["flash_attention"], SHARD_RUNS
        shard_io_check(qcfg, mesh, qwen, ckpt_dir)
        del qwen
        free_card()
        n = CUT_LAYERS["recurrentgemma-2b"]
        shard_step_check("cut", dataclasses.replace(
            get_config("recurrentgemma-2b"), n_layers=n), mesh, opt)
        free_card()
        shard_step_check("cut", dataclasses.replace(
            get_config("rwkv6-1.6b"), n_layers=SHARD_RWKV_LAYERS), mesh,
            opt)
        free_card()
        shard_step_check("cut", dataclasses.replace(
            get_config("qwen2-moe-a2.7b"), n_layers=SHARD_MOE_LAYERS),
            mesh, opt)
        free_card()
        c4_kernel_check(8, 128, 14, 2, 64)
        c4_kernel_check(8, 128, 10, 1, 256, window=2048)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the cost pass (ROADMAP A.8): launch/hlo.py and launch/dryrun.py
# ---------------------------------------------------------------------------

COST_RUNS = []
COST_LAUNCHES = {}       # launches of the counted real steps
COST_MEM_TOL = 0.05      # trace's argument + temp vs max_memory_allocated
# the dry run of qwen2-0.5b / train_4k / single, rank 0 of (16, 16): the
# hand counts of its FLOPs (held within 10%) and of argument + temp
# (held within 2x), and its argument bytes
DRYRUN_FLOPS_HAND, DRYRUN_FLOPS_TOL = 1.18e14, 0.10
DRYRUN_MEM_HAND = 20e9
DRYRUN_ARGUMENT = 46339972
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"))
# (arch, layers, B, S): the count held on the card for the routes
# qwen2-0.5b does not take, the hybrid's rg_lru and conv and the MoE's
# routing and expert dispatch, at full width with their depth cut
COST_CUT_STEPS = (("recurrentgemma-2b", 3, 2, 2048),
                  ("qwen2-moe-a2.7b", 2, 2, 1024))
DRYRUN_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
out = []
for arch, shape in json.loads(sys.argv[2]):
    rec = D.run_cell(arch, shape, "single")
    live = []
    if rec["status"] == "ok" and SHAPES[shape].kind == "train":
        # the storages live at the peak (a second trace of the cell)
        with D.fake_group(256):
            _, tr = D.trace_step(*D._build(get_config(arch), SHAPES[shape],
                                           make_production_mesh(), "train"))
        live = tr.live_at_peak(8)
    out.append({"record": rec, "live_at_peak": live})
print(json.dumps(out))
"""


def start_dryrun():
    """The dry run of ``DRYRUN_CELLS`` in a subprocess that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty): ``run_cell`` under its own fake
    256-rank group, on meta tensors."""
    import subprocess
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, SRC, json.dumps(DRYRUN_CELLS)],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cost_step_check(B: int, S: int, card: str, arch: str = "qwen2-0.5b",
                    layers: int = 0) -> dict:
    """One train step of full-width ``arch`` (bf16, remat per block,
    seed 0, B x S tokens; cut to ``layers`` where given) counted on meta
    tensors by the dry run's ``trace_step`` and run on the card: the
    trace's argument bytes are the state and batch on the card, the
    card's ``FlopCounterMode`` total (the kernels then go through their
    ops) equals the trace's FLOPs, and the trace's argument + temp is
    within ``COST_MEM_TOL`` of ``max_memory_allocated`` over a real
    step, its peak stats reset just before.  The real step is counted,
    and each kernel of the arch launched in it; a third step under
    ``hlo.Trace`` gives the card's own count (printed)."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo import Trace, storage_bytes
    from repro_torch.launch.train import build_state
    from repro_torch.models import lm
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import for_arch
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert cfg.remat == "block", cfg.remat
    opt = for_arch(cfg.arch_id)
    step = lm.make_train_step(cfg, opt)
    params = T.tree_abstract(T.param_defs(cfg), cfg)
    tok = lambda: torch.empty((B, S), dtype=torch.int32, device="meta")
    t0 = time.perf_counter()
    full, tr = D.trace_step(step, (
        {"params": params, "opt": opt.init_abstract(params),
         "step": torch.empty((), dtype=torch.int32, device="meta")},
        {"tokens": tok(), "labels": tok()}))
    trace_s = time.perf_counter() - t0
    mem = full["memory"]
    fake_total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]

    free_card()
    state = build_state(cfg, opt, 0, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B * S)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=gen,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "labels")}
    on_card = sum(storage_bytes((state, batch)).values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted(lambda: step(state, batch))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    loss = float(out[1]["loss"])
    del out
    for name, n in launches.items():
        COST_LAUNCHES[name] = COST_LAUNCHES.get(name, 0) + n
    free_card()
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    free_card()
    own = Trace()
    own.arguments(state, batch)
    with own:
        step(state, batch)
    torch.cuda.synchronize()
    del state, batch
    free_card()
    cut = f" cut to {layers} layers" if layers else ""
    row = {"cell": f"{arch}{cut} {B}x{S} bf16 remat=block, one device",
           "trace_s": trace_s, "fake_flops": full["flops"],
           "card_flops": card_flops,
           "fake_flops_by_op": dict(tr.flops_by_op),
           "fake_argument_bytes": mem["argument_size_in_bytes"],
           "fake_temp_bytes": mem["temp_size_in_bytes"],
           "card_argument_bytes": on_card, "allocated_before": before,
           "card_own_temp_bytes": own.peak - (mem["output_size_in_bytes"]
                                              - mem["alias_size_in_bytes"]),
           "max_memory_allocated": peak, "memory_ratio": fake_total / peak,
           "step_ms": step_ms, "loss": loss, "launches": launches,
           "live_at_peak": tr.live_at_peak(4)}
    print(f"[cost] real step {row['cell']}: FLOPs on the card {card_flops} "
          f"= trace {full['flops']:.0f} (by op {row['fake_flops_by_op']}); "
          f"trace {trace_s:.1f}s; loss {loss:.4f}; launches {launches}",
          flush=True)
    print(f"[cost] memory: trace argument + temp {fake_total} B (argument "
          f"{mem['argument_size_in_bytes']} = state and batch on the card "
          f"{on_card}; temp {mem['temp_size_in_bytes']}, the card's own "
          f"count's {row['card_own_temp_bytes']}) against "
          f"max_memory_allocated {peak} B (allocated before the step "
          f"{before}): ratio {row['memory_ratio']:.4f} (bar 1 +- "
          f"{COST_MEM_TOL}); largest live at the trace's peak "
          f"{[(r['shape'], r['dtype']) for r in row['live_at_peak']]} on "
          f"{card}", flush=True)
    assert on_card == mem["argument_size_in_bytes"], row
    assert card_flops == full["flops"], row
    assert abs(row["memory_ratio"] - 1.0) <= COST_MEM_TOL, row
    if layers:
        used = {"flash_attention": "attn", "rg_lru_scan": "rec"}
        assert all(launches[k] > 0 for k, kind in used.items()
                   if kind in cfg.block_pattern), launches
    else:
        assert launches["flash_attention"] == \
            TRAIN_LAUNCHES[arch]["flash_attention"], launches
    COST_RUNS.append(row)
    return row


def cost_phase(card: str) -> dict:
    """The cost pass (ROADMAP A.8): the flash wrapper's host time a
    call; the dry run of ``DRYRUN_CELLS`` in a subprocess, meanwhile the
    one-device steps of ``cost_step_check``, qwen2-0.5b's at 8 x 128
    and 2 x 4096 and the cut ones of ``COST_CUT_STEPS``; then
    each dry-run record's FLOPs, collectives, argument + temp and
    roofline terms, the train cell held to its hand counts.  Returns the
    wrapper's timing."""
    import torch
    from repro_torch.benchmarks.flash_host import measure
    # the host time first, while no child competes for the host's cores
    shape = (8, 128, 14, 2, 64)
    host = measure(shape, torch.device("cuda"), rounds=15)
    print(f"[cost] flash wrapper bf16 (B, S, H, KV, dh)={shape}: host "
          f"{host['host_us_per_call']:.2f} us a call (min "
          f"{host['host_us_min']:.2f}, max {host['host_us_max']:.2f}), "
          f"device {host['kernel_ms']:.5f} ms on {card}", flush=True)
    child = start_dryrun()
    try:
        cost_step_check(8, 128, card)
        cost_step_check(2, 4096, card)
        for arch, layers, B, S in COST_CUT_STEPS:
            cost_step_check(B, S, card, arch, layers)
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    records = []
    for cell in json.loads(out.strip().splitlines()[-1]):
        rec = cell["record"]
        records.append(rec)
        assert rec["status"] == "ok", rec.get("traceback", rec)
        f, r = rec["full"], rec["roofline"]
        mem = f["memory"]
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        coll = {k: (v["count"], v["operand_bytes"])
                for k, v in sorted(f["collectives"].items())}
        print(f"[cost] dryrun {rec['arch']} {rec['shape']} single (16, 16) "
              f"rank 0, H100 constants: trace {f['compile_s']}s "
              f"FLOPs={f['flops']:.6e} collective_bytes="
              f"{f['collective_bytes_per_device']:.6e} by category (count, "
              f"operand bytes) {coll} argument+temp={total} (argument "
              f"{mem['argument_size_in_bytes']}, temp "
              f"{mem['temp_size_in_bytes']}, output "
              f"{mem['output_size_in_bytes']}, alias "
              f"{mem['alias_size_in_bytes']}) modeled_bytes="
              f"{rec['modeled_bytes']['total']:.6e} terms s: compute "
              f"{r['compute_s']:.6f} memory {r['memory_s']:.6f} collective "
              f"{r['collective_s']:.6f} dominant {r['dominant']} "
              f"useful_flops_ratio {r['useful_flops_ratio']:.4f} "
              f"roofline_fraction {r['roofline_fraction']:.6f}", flush=True)
        if cell["live_at_peak"]:
            print(f"[cost] dryrun {rec['arch']} {rec['shape']} live at the "
                  f"peak: {cell['live_at_peak']}", flush=True)
        COST_RUNS.append({"cell": f"{rec['arch']}/{rec['shape']}/single",
                          "flops": f["flops"], "collectives": f["collectives"],
                          "memory": mem, "roofline": r,
                          "trace_s": f["compile_s"],
                          "live_at_peak": cell["live_at_peak"]})
        if rec["kind"] == "train":
            assert abs(f["flops"] / DRYRUN_FLOPS_HAND - 1) <= \
                DRYRUN_FLOPS_TOL, f["flops"]
            assert DRYRUN_MEM_HAND / 2 <= total <= 2 * DRYRUN_MEM_HAND, total
            assert mem["argument_size_in_bytes"] == DRYRUN_ARGUMENT, mem
        else:
            assert f["flops"] > 0 and f["collective_bytes_per_device"] > 0
    cost_readers(records)
    return host


def cost_readers(records: list) -> None:
    """The dry run's readers (ROADMAP A.9) over the cost phase's records,
    written into a temporary folder as ``single/<arch>__<shape>.json``
    with one skipped record (``run_cell``'s shape check alone) and one
    tagged copy: ``launch/recompute`` re-derives every ok record's
    ``modeled_bytes`` and ``roofline``, equal to what the dry run wrote;
    ``launch/report`` writes its document there, with one ok row a cell
    in §Dry-run and in §Roofline (the record's ``roofline_fraction`` at
    3 places), the SKIP row, no row of the tagged copy, and the H100
    constants on the hardware line.  The tables print on ``[cost]``
    lines."""
    import io
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import recompute, report
    skipped = D.run_cell("qwen2-0.5b", "long_500k", "single")
    assert skipped["status"] == "skipped", skipped
    tagged = json.loads(json.dumps(records[0]))
    tagged["full"]["compile_s"] = 12345.6
    saved = (recompute.ART, report.ART, report.PERF, report.OUT)
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "single"))
        files = {f"{r['arch']}__{r['shape']}": r for r in records}
        files["qwen2-0.5b__long_500k"] = skipped
        files[f"{records[0]['arch']}__{records[0]['shape']}__tagged"] = tagged
        for name, rec in files.items():
            with open(os.path.join(d, "single", f"{name}.json"), "w") as f:
                json.dump(rec, f, indent=1)
        out = io.StringIO()
        try:
            recompute.ART = report.ART = d
            report.PERF = os.path.join(d, "perf_log.json")
            report.OUT = os.path.join(d, "EXPERIMENTS.md")
            with contextlib.redirect_stdout(out):
                recompute.main()
                report.main()
            again = {}
            for r in records:
                path = os.path.join(d, "single",
                                    f"{r['arch']}__{r['shape']}.json")
                with open(path) as f:
                    again[(r["arch"], r["shape"])] = json.load(f)
            with open(report.OUT) as f:
                doc = f.read()
            cells = report.load("single")
            dry = report.dryrun_table(cells, "single")
            roof = report.roofline_table(cells)
        finally:
            recompute.ART, report.ART, report.PERF, report.OUT = saved
    said = out.getvalue().splitlines()
    print(f"[cost] recompute: {said[0]}; report: "
          f"{said[1].split(' (')[-1].rstrip(')')}", flush=True)
    for line in (dry + "\n" + roof).splitlines():
        print(f"[cost] report {line}", flush=True)
    assert said[0] == f"recomputed {len(records) + 1} artifacts", said
    for r in records:
        key = (r["arch"], r["shape"])
        assert again[key]["modeled_bytes"] == r["modeled_bytes"], key
        assert again[key]["roofline"] == r["roofline"], key
        frac = f"**{r['roofline']['roofline_fraction']:.3f}**"
        assert sum(line.startswith(f"| {key[0]} | {key[1]} | ok |")
                   for line in dry.splitlines()) == 1, dry
        assert [line for line in roof.splitlines()
                if line.startswith(f"| {key[0]} | {key[1]} |")
                and line.endswith(f"| {frac} |")] != [], roof
    assert len(roof.splitlines()) == 2 + len(records), roof
    assert "| qwen2-0.5b | long_500k | SKIP |" in dry, dry
    assert "12345.6" not in doc and dry in doc and roof in doc
    hw = next(p for p in doc.split("\n\n") if "Hardware constants" in p)
    assert all(report.eng(c) in hw
               for c in (D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW)), hw
    hw = " ".join(hw[hw.index("Hardware constants"):].split())
    print(f"[cost] report {hw}", flush=True)


T0 = time.perf_counter()


def lap(name: str) -> None:
    """Print the seconds since the script started, after ``name``."""
    print(f"[time] {name} done at {time.perf_counter() - T0:.1f}s",
          flush=True)


def main() -> int:
    # the training phases' full-width optimizer steps allocate multi-GB
    # float32 temporaries between the backward's freed blocks: grow
    # segments instead of splitting cached ones (set before CUDA starts)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    train_k = train_kernel_checks()
    lap("training kernel checks")
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
    # the training phase's checkpoints (about 10 GB), which the shard
    # phase restores, are deleted however either phase ends
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_",
                                dir=os.path.join(ROOT, "build"))
    try:
        train_phases(ckpt_dir)
        lap("training phases")
        shard_phases(ckpt_dir)
        lap("shard phases")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card()
    flash_host = cost_phase(card)
    lap("cost phase")
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
    from repro_torch.configs import ARCHS
    for arch in ARCHS:
        train_reference_check(arch)
    lap("training reference checks")

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
        # the parts of ``launches`` the fleet serves and the training
        # runs made
        k["fleet_launches"] = FLEET_LAUNCHES.get(k["name"], 0)
        k["train_launches"] = TRAIN_LAUNCHES_TOTAL.get(k["name"], 0)
        k["shard_launches"] = SHARD_LAUNCHES.get(k["name"], 0)
        k["cost_launches"] = COST_LAUNCHES.get(k["name"], 0)
    # the training route: flash's forward and backward (plain PyTorch),
    # the reversed rg_lru scan
    kernels[2].update(
        train_fwd_ms=train_k["fwd_ms"], train_bwd_ms=train_k["bwd_ms"],
        train_bwd_bound_ms=train_k["bwd_bound_ms"],
        train_grad_rel_err=train_k["grad_err"],
        train_shape="bf16 (8, 128, 14/2, 64) causal",
        wrapper_host_us=flash_host["host_us_per_call"],
        wrapper_fwd_ms=flash_host["kernel_ms"])
    kernels[3].update(train_bwd_rel_err=train_k["rg_lru_bwd_err"])
    print(json.dumps({"train_runs": TRAIN_RUNS}), flush=True)
    print(json.dumps({"shard_runs": SHARD_RUNS}), flush=True)
    print(json.dumps({"cost_runs": COST_RUNS}), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
