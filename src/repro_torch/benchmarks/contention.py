"""Paper Figs 11-12 (MicroBlaze contention): DMA under concurrent compute,
on the card.

Twin of ``benchmarks/contention.py``.  The paper's second AXI master is,
on the card, compute sharing device memory with the copy engines.  Each
row times the same H2C transfer through a ``ChannelPool`` (host wall
time, median of 3) idle and then with a burner thread multiplying
matrices on its own CUDA stream, and reports the slowdown factor next to
the paper's 10.8 -> 9.5 GB/s (x0.88) single-channel drop.

The reference's ``a @ a`` on a (256, 256) float32 operand takes
microseconds on an H100, less than its launch, and would load nothing;
on the card the burner multiplies a (4096, 4096) float32 operand (137
GFLOP a product, milliseconds each), (256, 256) on the CPU.  It writes
each product into one preallocated output (no chain, so no overflow and
no allocation) and synchronises only its own stream, never the device.
A Python burner competes for the interpreter lock as well as for device
memory, so each row also prints the burner's products per second.

    python -m repro_torch.benchmarks.contention [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import threading
import time
from typing import List

import numpy as np
import torch

from repro_torch.benchmarks.common import bench_seed, emit, time_call
from repro_torch.core.analytical import paper_pcie_ddr4
from repro_torch.core.channels import ChannelPool
from repro_torch.device import resolve_device

SIZE = 1 << 22
BURN_N = {"cuda": 4096, "cpu": 256}


class Burner:
    """A thread that multiplies ``a @ a`` into ``c`` until stopped, on its
    own stream on the card; ``products`` counts finished products."""

    def __init__(self, dev: torch.device):
        n = BURN_N[dev.type]
        gen = torch.Generator(device=dev)
        gen.manual_seed(bench_seed())
        self.a = torch.randn((n, n), generator=gen, device=dev)
        self.c = torch.empty_like(self.a)
        self.stream = torch.cuda.Stream(device=dev) \
            if dev.type == "cuda" else None
        self.products = 0
        self._warm = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._burn, daemon=True,
                                        name="contention-burner")

    def _burn(self) -> None:
        ctx = torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()
        with ctx:
            while not self._stop.is_set():
                torch.mm(self.a, self.a, out=self.c)
                if self.stream is not None:
                    self.stream.synchronize()
                if not self._warm.is_set():
                    # the thread's first product sets up its cuBLAS
                    # handle: neither timed nor counted
                    self.t0 = time.perf_counter()
                    self._warm.set()
                    continue
                self.products += 1

    def __enter__(self):
        self._thread.start()
        if not self._warm.wait(timeout=60):
            raise RuntimeError("contention burner did not start")
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        self.seconds = time.perf_counter() - self.t0
        if self._thread.is_alive():
            raise RuntimeError("contention burner did not stop")


def run(quick: bool = False, device=None) -> List[dict]:
    dev = resolve_device(device)
    size = (1 << 20) if quick else SIZE
    host = np.random.default_rng(bench_seed()).standard_normal(size // 8)
    out = []
    for nch in (1, 4):
        with ChannelPool(nch, device=dev, chunk_bytes=1 << 20) as pool:
            t_idle = time_call(lambda: pool.h2c(host).wait(), repeats=3)
            with Burner(dev) as burner:
                t_busy = time_call(lambda: pool.h2c(host).wait(), repeats=3)
            factor = t_idle / t_busy
            rate = burner.products / burner.seconds
            emit(f"fig11_contention_ch{nch}", t_busy * 1e6,
                 f"idle={size/t_idle/1e9:.2f}GB/s busy="
                 f"{size/t_busy/1e9:.2f}GB/s factor={factor:.2f} "
                 f"paper_factor={paper_pcie_ddr4().contention_factor} "
                 f"burner={rate:.1f}products/s")
            out.append({"channels": nch, "idle_s": t_idle, "busy_s": t_busy,
                        "factor": factor, "burner_products_per_s": rate})
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
