"""Paper Figs 19-20 (RDMA read/write): the device<->device path, on the
card.

Twin of ``benchmarks/rdma_analogue.py``.  RDMA on the SoC SmartNIC is
the 'easy API on a separate link' path; the reference measures it as
``jax.device_put`` between two of eight host devices in a subprocess.
A one-card machine has one device<->device transfer, a copy between two
allocations in the card's memory, so the twin needs no subprocess and
the peer is the same card (``peer=self`` in each row):

* write analogue: a tensor -> a preallocated peer buffer;
* read analogue: the peer buffer -> the tensor.

Each call copies and synchronises (the reference blocks until ready),
so each row holds host wall time (median of 3).  ``d2d_model`` is the
``h100_d2d_path`` model at that size, in the place of the reference's
``ici_model``.  Each direction is checked byte for byte once.

    python -m repro_torch.benchmarks.rdma_analogue [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch.benchmarks.common import emit, time_call
from repro_torch.core.analytical import bandwidth_gbps, h100_d2d_path
from repro_torch.core.channels import Direction
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(quick: bool = False, device=None) -> List[dict]:
    dev = resolve_device(device)
    sizes = [1 << 18, 1 << 20] if quick else [1 << 18, 1 << 20, 1 << 22]
    model = h100_d2d_path()
    out = []
    for size in sizes:
        n = size // 4
        x = torch.arange(n, dtype=torch.float32, device=dev)
        peer = torch.empty_like(x)
        want = x.view(torch.int32).clone()

        def write():
            peer.copy_(x)
            _sync(dev)

        def read():
            x.copy_(peer)
            _sync(dev)

        for op, fn, dst in (("write", write, peer), ("read", read, x)):
            dst.zero_()
            fn()
            if not torch.equal(dst.view(torch.int32), want):
                raise AssertionError(f"rdma {op} {size}B: bytes differ")
            t = time_call(fn, repeats=3)
            proj = bandwidth_gbps(model, size, 1, Direction.C2H)
            emit(f"fig19_20_rdma_{op}_{size >> 10}KB", t * 1e6,
                 f"meas={size/t/1e9:.2f}GB/s peer=self "
                 f"d2d_model={proj:.1f}GB/s")
            out.append({"op": op, "size_bytes": size, "seconds": t,
                        "meas_gbps": size / t / 1e9, "d2d_model_gbps": proj})
    return out


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
