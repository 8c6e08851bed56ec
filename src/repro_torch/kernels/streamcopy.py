"""Tiered stream copy: device memory -> shared memory -> device memory
through ``n_buffers`` in-flight stages.

Twin of ``repro/kernels/streamcopy.py``, the paper's multi-channel DMA
engine on the card's memory hierarchy: ``n_buffers`` plays the XDMA
channel count and ``block_rows`` the transfer size.
``stream_copy(x, block_rows=, n_buffers=)`` copies a 2-D (R, C) tensor of
any dtype in blocks of ``block_rows`` rows.  It raises ``ValueError``
where the reference asserts (``R % block_rows != 0``) and on
``n_buffers < 1``.

On CUDA tensors it launches the CUDA C++ kernel of ``csrc/stream_copy.cu``
(one launch, on the current stream) or raises; on CPU tensors it runs the
plain version beside it, ``stream_copy_torch`` (``x.clone()``).  Nothing
falls back from the card to the plain version.  ``stream_copy.launches``
counts the kernel's launches.  Both give the input's bytes exactly,
-0.0 and NaN payloads included.

``plan`` is the kernel's layout rule (how many CTAs share each block, and
each one's stage size); the source note of ``csrc/stream_copy.cu``
explains it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

MAX_SMEM = 232448           # dynamic shared memory one CTA may use
ALIGN = 16                  # bulk copies move 16-byte aligned extents
LINE = 128                  # slices start on 128-byte lines
STAGES_PER_SM = 4           # ring stages the plan puts on each SM


def stream_copy_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x.clone()``, the input's bytes exactly."""
    return x.clone()


def _header_bytes(n_buffers: int) -> int:
    return (8 * n_buffers + 127) // 128 * 128


def plan(block_bytes: int, n_buffers: int, n_sms: int) -> Tuple[int, int]:
    """(P, slice_bytes): the kernel cuts each block of ``block_bytes``
    into P slices of ``slice_bytes`` (a multiple of ``LINE``; the last one
    shorter), one per CTA, each with ``n_buffers`` stages of that size.

    P follows the copy: about ``STAGES_PER_SM`` stages on each SM, so one
    CTA (four buffers), two (two) or four (one buffer) share an SM and one
    CTA's wait for its store to read a stage hides behind another's load;
    more CTAs where the stages would not fit ``MAX_SMEM``; never a slice
    under ``LINE`` bytes but the last.  Raises ``ValueError`` where no P
    fits."""
    if block_bytes < ALIGN or block_bytes % ALIGN:
        raise ValueError(f"stream_copy's kernel moves blocks of a multiple "
                         f"of {ALIGN} bytes, not {block_bytes}")
    budget = MAX_SMEM - _header_bytes(n_buffers)
    max_slice = budget // n_buffers // LINE * LINE
    if max_slice < LINE:
        raise ValueError(f"{n_buffers} stages of {LINE} bytes do not fit "
                         f"{MAX_SMEM} bytes of shared memory")
    n = max(n_sms * max(1, STAGES_PER_SM // n_buffers),
            -(-block_bytes // max_slice))
    n = min(n, -(-block_bytes // LINE))
    slice_bytes = -(-block_bytes // n)
    slice_bytes = -(-slice_bytes // LINE) * LINE
    return -(-block_bytes // slice_bytes), slice_bytes


def _kernels() -> ctypes.CDLL:
    lib = build.load("stream_copy")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.stream_copy_launch.argtypes = [vp, vp, i64, i32, i32, i32, i32,
                                           vp]
        lib.stream_copy_launch.restype = i32
        lib._typed = True
    return lib


def _check(x: torch.Tensor, block_rows: int, n_buffers: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"stream_copy takes a 2-D (R, C) tensor, got "
                         f"{tuple(x.shape)}")
    if block_rows < 1 or x.shape[0] % block_rows:
        raise ValueError(f"R={x.shape[0]} is not a multiple of "
                         f"block_rows={block_rows}")
    if n_buffers < 1:
        raise ValueError(f"n_buffers must be >= 1, got {n_buffers}")


def stream_copy(x: torch.Tensor, *, block_rows: int = 256,
                n_buffers: int = 2) -> torch.Tensor:
    """Copy an (R, C) tensor through ``n_buffers`` stages in
    ``block_rows`` blocks; returns a new tensor with ``x``'s bytes."""
    _check(x, block_rows, n_buffers)
    if x.device.type == "cpu":
        return stream_copy_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"stream_copy runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("stream_copy's kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    n_blocks = x.shape[0] // block_rows
    if out.numel() == 0:
        return out
    block_bytes = block_rows * x.shape[1] * x.element_size()
    if x.data_ptr() % ALIGN or out.data_ptr() % ALIGN:
        raise ValueError(f"stream_copy's kernel needs {ALIGN}-byte aligned "
                         f"tensors")
    n_ctas, slice_bytes = plan(block_bytes, n_buffers, sm_count(x.device))
    build.check(_kernels().stream_copy_launch(
        x.data_ptr(), out.data_ptr(), block_bytes, n_blocks, slice_bytes,
        n_ctas, n_buffers,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)),
        "stream_copy")
    stream_copy.launches += 1
    return out


stream_copy.launches = 0
