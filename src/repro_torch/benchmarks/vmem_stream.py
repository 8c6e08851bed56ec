"""Paper Fig 8: on-chip tier bandwidth against transfer size and channel
count, on the card.

Twin of ``benchmarks/vmem_stream.py``.  Runs ``stream_copy`` (the CUDA
kernel of ``csrc/stream_copy.cu``) over the same grid: blocks of
``BLOCK_ROWS`` rows of ``COLS`` float32 (the transfer size) through
``BUFFERS`` in-flight stages (the channel count), on a seeded (512, 512)
input, (256, 512) with ``--quick``.  Each row is
``fig8_vmem_block{br}x{COLS}_buf{nb}``, device µs per call, then:

* ``h100_copy``: bytes copied per device second;
* ``bound_share``: the card's copy bound (2 x bytes over 3.35 TB/s, the
  H100 SXM data sheet) over the measured time;
* ``paper_bram``: the paper's BRAM-path model at that transfer size and
  channel count (``core/analytical.py``), the figure the sweep is shaped
  after.

The reference's ``modeled_tpu`` column has no counterpart: it models a
TPU's HBM, not this card.  Every output is checked byte for byte against
the input.  ``--device cpu`` runs the plain version only; its rows hold
host µs and print the card's fields as not measured.

    python -m repro_torch.benchmarks.vmem_stream [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_seed, emit,
                                           set_bench_seed, time_call)
from repro_torch.core.analytical import bandwidth_gbps, paper_pcie_bram
from repro_torch.core.channels import Direction
from repro_torch.device import resolve_device, sm_count
from repro_torch.kernels import ops
from repro_torch.kernels.streamcopy import plan

BLOCK_ROWS = [8, 32, 128]
BUFFERS = [1, 2, 4]
COLS = 512
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peak, 700 W limit


def run(quick: bool = False, device=None) -> List[dict]:
    """Sweep the grid; returns one dict per row (also emitted as CSV)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rows_total = 256 if quick else 512
    bram = paper_pcie_bram()
    x = torch.from_numpy(np.random.default_rng(bench_seed())
                         .standard_normal((rows_total, COLS))
                         .astype(np.float32)).to(dev)
    want = x.view(torch.int32)
    out = []
    for br in (BLOCK_ROWS[:2] if quick else BLOCK_ROWS):
        for nb in (BUFFERS[:2] if quick else BUFFERS):
            def fn():
                return ops.stream_copy(x, block_rows=br, n_buffers=nb)
            if not torch.equal(fn().view(torch.int32), want):
                raise AssertionError(f"stream_copy block_rows={br} "
                                     f"n_buffers={nb}: bytes differ")
            t = time_call(fn, repeats=9 if cuda else 2, warmup=2,
                          calls=20 if cuda else 1, device=dev)
            block_bytes = br * COLS * 4
            nbytes = x.numel() * 4
            paper_bw = bandwidth_gbps(bram, block_bytes, nb, Direction.C2H)
            row = {"name": f"fig8_vmem_block{br}x{COLS}_buf{nb}",
                   "block_rows": br, "n_buffers": nb,
                   "block_bytes": block_bytes, "bytes": nbytes,
                   "us": t * 1e6, "paper_bram_gbps": paper_bw}
            if cuda:
                ctas, stage = plan(block_bytes, nb, sm_count(dev))
                row.update(h100_copy_gbps=nbytes / t / 1e9,
                           bound_share=2 * nbytes / HBM_BYTES_PER_S / t,
                           ctas=ctas, stage_bytes=stage)
                card = (f"h100_copy={row['h100_copy_gbps']:.1f}GB/s "
                        f"bound_share={row['bound_share']:.3f} "
                        f"ctas={ctas} stage={stage}B")
            else:
                card = "h100_copy=not_measured bound_share=not_measured"
            emit(row["name"], row["us"],
                 f"block={block_bytes >> 10}KB {card} "
                 f"paper_bram={paper_bw:.1f}GB/s")
            out.append(row)
    return out


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu (the plain "
                         "version only)")
    args = ap.parse_args(argv)
    set_bench_seed(args.seed)
    return run(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
