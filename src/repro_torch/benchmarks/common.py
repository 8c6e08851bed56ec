"""Shared benchmark utilities: the run's seed, timing, CSV row emission.

Twin of ``benchmarks/common.py``.  ``time_call`` takes device time with
CUDA events for work on a CUDA device and host time otherwise; a row
says which it holds.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List

import torch

ROWS: List[str] = []

# the run's RNG seed: every benchmark draws its data from it
_BENCH_SEED = 0


def set_bench_seed(seed: int) -> None:
    global _BENCH_SEED
    _BENCH_SEED = int(seed)


def bench_seed() -> int:
    return _BENCH_SEED


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    row = f"{name},{us_per_call:.1f},{derived}"
    ROWS.append(row)
    print(row, flush=True)


def time_call(fn: Callable, *, repeats: int = 5, warmup: int = 1,
              calls: int = 1, device=None) -> float:
    """Median seconds per ``fn()`` call over ``repeats`` runs of ``calls``
    calls each.

    On a CUDA ``device`` the time is the device's: a sleep kernel holds
    the stream while the host enqueues the calls, so the two events
    bracket back-to-back device work, not the host's enqueue.  Otherwise
    it is host time around the calls."""
    cuda = device is not None and torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times)
