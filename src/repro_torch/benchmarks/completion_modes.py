"""Paper Figs 13-14 (PetaLinux / managed runtime) + polled-vs-interrupt,
on the card.

Twin of ``benchmarks/completion_modes.py``.  Compares POLLED (the caller
blocks on ``wait``) against INTERRUPT (a completion callback) on one
``ChannelPool``, then the XDMA-style pool against the QDMA-style queue
engine behind ``MemoryEngine`` (its scheduler thread is the 'managed
runtime' overhead the paper attributes to PetaLinux designs).  Every
call waits on the host, so each row holds host wall time (median of 3),
never CUDA events.  The transfer is a seeded float64 array of 4 MiB
(1 MiB with ``--quick``); each path's result is checked byte for byte
against it once.

    python -m repro_torch.benchmarks.completion_modes [--quick]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from repro_torch.benchmarks.common import bench_seed, emit, time_call
from repro_torch.core.channels import ChannelPool, CompletionMode, Direction
from repro_torch.core.engine import MemoryEngine
from repro_torch.device import resolve_device

SIZE = 1 << 22


def _check(got: torch.Tensor, host: np.ndarray, what: str) -> None:
    if not np.array_equal(got.cpu().numpy().view(np.uint8),
                          host.view(np.uint8)):
        raise AssertionError(f"{what}: H2C bytes differ from the host's")


def run(quick: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    size = (1 << 20) if quick else SIZE
    host = np.random.default_rng(bench_seed()).standard_normal(size // 8)
    out = {}

    with ChannelPool(2, device=dev, chunk_bytes=1 << 20) as pool:
        _check(pool.submit(host, Direction.H2C).wait(), host, "polled")
        t_poll = time_call(lambda: pool.submit(
            host, Direction.H2C, mode=CompletionMode.POLLED).wait(),
            repeats=3)

        def interrupt_once():
            done = threading.Event()
            pool.submit(host, Direction.H2C,
                        mode=CompletionMode.INTERRUPT,
                        on_complete=lambda tr: done.set())
            done.wait()
        t_intr = time_call(interrupt_once, repeats=3)
    emit("fig13_polled_h2c", t_poll * 1e6,
         f"{size/t_poll/1e9:.2f}GB/s")
    emit("fig13_interrupt_h2c", t_intr * 1e6,
         f"{size/t_intr/1e9:.2f}GB/s overhead="
         f"{(t_intr/t_poll-1)*100:.1f}%")
    out["polled_s"], out["interrupt_s"] = t_poll, t_intr

    for path in ("xdma", "qdma"):
        with MemoryEngine(n_channels=2, path=path, device=dev) as eng:
            _check(eng.write(host).wait(), host, path)
            t = time_call(lambda: eng.write(host).wait(), repeats=3)
            emit(f"fig14_{path}_managed_h2c", t * 1e6,
                 f"{size/t/1e9:.2f}GB/s")
        out[f"{path}_s"] = t
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
