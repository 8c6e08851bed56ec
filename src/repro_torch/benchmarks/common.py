"""Shared benchmark utilities: the run's seed, timing, CSV row emission,
JSON artifacts and the card's own ceilings.

Twin of ``benchmarks/common.py``.  ``time_call`` takes device time with
CUDA events for kernel work on a CUDA device and host time otherwise; a
row says which it holds.  ``pinned_h2d_gbps`` takes the place of the
reference's ``cpu_memcpy_ceiling_gbps``: the host<->device rows scale
against the card's pinned host->device rate, not a host memcpy.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from typing import Callable, List

import torch

from repro_torch import obs

ROWS: List[str] = []

# the run's RNG seed: every benchmark draws its data from it
_BENCH_SEED = 0


def set_bench_seed(seed: int) -> None:
    global _BENCH_SEED
    _BENCH_SEED = int(seed)


def bench_seed() -> int:
    return _BENCH_SEED


def write_bench_json(path: str, payload: dict) -> dict:
    """Write a ``BENCH_*.json`` with the obs metrics snapshot embedded.

    Every artifact carries the process-wide registry state under
    ``"metrics"`` (empty when nothing was recorded) and the run's RNG
    ``"seed"``.  Returns the payload (with the snapshot)."""
    payload.setdefault("metrics", obs.default_registry().snapshot())
    payload.setdefault("seed", bench_seed())
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
    print(f"# wrote {path}", flush=True)
    return payload


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
    it is host time around the calls.

    A ``fn`` that waits on the host (a DMA transfer's ``.wait()``, a
    verbs doorbell, a store operation, a serve) must be timed with
    ``device=None``: its copies are ordered behind the sleep kernel on
    the same stream, so the host would wait out the sleep inside the
    timed window and the events would measure the sleep."""
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


def l2_rotation(device, set_bytes: int) -> int:
    """How many copies of one call's buffers (``set_bytes`` each) a timed
    loop cycles through so that no call finds its bytes in the card's
    L2: enough to cover three times the L2 (at least 2).  Off the card,
    1."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(2, -(-3 * l2 // max(1, set_bytes)))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _copy_gbps(dst: torch.Tensor, src: torch.Tensor, repeats: int) -> float:
    """Bytes per second of ``dst.copy_(src)`` (CUDA events, median of
    ``repeats`` after two warm-ups)."""
    rates = []
    for _ in range(repeats + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        rates.append(src.nbytes / (start.elapsed_time(end) * 1e-3) / 1e9)
    return statistics.median(rates[2:])


def pinned_h2d_gbps(nbytes: int = 64 << 20, repeats: int = 10) -> float:
    """Pinned host->device rate of one ``nbytes`` copy: the ceiling the
    host<->device rows scale against.  Needs a card."""
    return _copy_gbps(torch.empty(nbytes, dtype=torch.uint8, device="cuda"),
                      torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=True), repeats)


def d2d_copy_gbps(nbytes: int = 256 << 20, repeats: int = 10) -> float:
    """Rate of one ``nbytes`` ``copy_`` between two allocations on the
    card: the ceiling of ``h100_d2d_path``.  Needs a card."""
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    return _copy_gbps(torch.empty_like(src), src, repeats)


def d2d_copy_latency_us(nbytes: int = 4096, repeats: int = 50) -> float:
    """Host microseconds of one small ``copy_`` on the card and a
    synchronize (median of ``repeats``): the per-op setup of
    ``h100_d2d_path``.  Needs a card."""
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_call(lambda: (dst.copy_(src), torch.cuda.synchronize()),
                     repeats=repeats, warmup=5) * 1e6

