"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

Twin of ``repro/kernels/rg_lru.py``.  ``rg_lru_scan(a, b, h0)`` takes
``a``, ``b`` of shape (B, T, W) float32 and ``h0`` of shape (B, W) float32
or None (zeros), and returns every ``h_t`` as (B, T, W) float32.  T and W
may have any size: the reference's ``T % block_t == 0`` is not carried
over.

On CUDA tensors it launches the CUDA C++ kernel of ``csrc/rg_lru.cu`` (one
launch, on the current stream) or raises; on CPU tensors it runs the plain
PyTorch version beside it, ``rg_lru_scan_torch``.  Nothing falls back
from the card to the plain version.  ``rg_lru_scan.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build


def rg_lru_scan_torch(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: a loop over T in float32, each step a
    rounded multiply and a rounded add."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def _kernels() -> ctypes.CDLL:
    lib = build.load("rg_lru")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rg_lru_scan_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.rg_lru_scan_launch.restype = i32
        lib._typed = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"both be (B, T, W)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a, b must be float32, got {a.dtype}, {b.dtype}")
    if h0 is not None and (tuple(h0.shape) != (a.shape[0], a.shape[2])
                           or h0.dtype != torch.float32):
        raise ValueError(f"h0 {h0.dtype}{tuple(h0.shape)}: want float32 "
                         f"{(a.shape[0], a.shape[2])}")
    devs = {t.device for t in (a, b, h0) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devs))}")


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, T, W) float32; h0: (B, W) float32 or None -> h (B, T, W)."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rg_lru_scan_torch(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru_scan runs on cuda or cpu, not {a.device}")
    B, T, W = a.shape
    if B * T * W == 0:
        return torch.empty_like(a)
    if not all(t.is_contiguous() for t in (a, b, h0) if t is not None):
        raise ValueError("rg_lru_scan's kernel takes contiguous tensors")
    out = torch.empty_like(a)
    build.check(_kernels().rg_lru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), B, T, W,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)),
        "rg_lru_scan")
    rg_lru_scan.launches += 1
    return out


rg_lru_scan.launches = 0
