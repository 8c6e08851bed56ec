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

``plan`` is the kernel's launch rule (channels per CTA, time steps per
stage, ring depth, TMA or cp.async route) and ``tensor_map`` the TMA
geometry it implies; the source note of ``csrc/rg_lru.cu`` explains both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

MAX_SMEM = 232448        # dynamic shared memory one CTA may use
TILES = (16, 32)         # channels of a CTA
STEPS = 64               # time steps of a stage
IN_FLIGHT = 8 << 20      # bytes of a and b the ring keeps in flight


class LruPlan(ctypes.Structure):
    """``struct LruPlan`` of ``csrc/rg_lru.cu``."""
    _fields_ = [("tile", ctypes.c_int), ("steps", ctypes.c_int),
                ("stages", ctypes.c_int), ("tma", ctypes.c_int)]


class LruMap(ctypes.Structure):
    """``struct LruMap`` of ``csrc/rg_lru.cu``: one 3-D tensor map."""
    _fields_ = [("dims", ctypes.c_ulonglong * 3),
                ("strides", ctypes.c_ulonglong * 2),
                ("box", ctypes.c_uint * 3)]


def header_bytes(stages: int) -> int:
    return (16 * stages + 127) // 128 * 128


def stage_bytes(pl: LruPlan) -> int:
    """One stage: ``steps`` rows of the tile's a, then of its b."""
    return 2 * pl.steps * pl.tile * 4


def smem_bytes(pl: LruPlan) -> int:
    """The ring, then two h buffers of a stage's size (one being written
    while the other's TMA store reads it)."""
    return header_bytes(pl.stages) + (pl.stages + 1) * stage_bytes(pl)


def n_ctas(pl: LruPlan, B: int, W: int) -> int:
    """One CTA per (batch row, tile of channels)."""
    return B * -(-W // pl.tile)


def plan(B: int, T: int, W: int, n_sms: int,
         aligned: bool = True) -> LruPlan:
    """The launch of a (B, T, W) scan on ``n_sms`` SMs.

    Tiles of 32 channels where ``B * ceil(W / 32)`` CTAs cover the SMs,
    else 16; stages of ``STEPS`` time steps; enough stages that the CTAs
    hold ``IN_FLIGHT`` bytes in their rings, at least two (one where the
    scan has one stage), at most the scan's own stage count and what fits
    ``MAX_SMEM``.  TMA where the rows are 16-byte multiples
    (``W % 4 == 0``) and a, b 16-byte aligned (``aligned``), else
    cp.async."""
    tile = TILES[1] if B * -(-W // TILES[1]) >= n_sms else TILES[0]
    pl = LruPlan(tile=tile, steps=STEPS, stages=1,
                 tma=int(W % 4 == 0 and aligned))
    stage = stage_bytes(pl)
    chunks = -(-T // STEPS)
    want = -(-IN_FLIGHT // (n_ctas(pl, B, W) * stage))
    # header_bytes(s) <= 16 s + 112: the most stages that fit MAX_SMEM
    fit = (MAX_SMEM - 112 - stage) // (stage + 16)
    pl.stages = min(max(want, 2), fit, chunks)
    return pl


def tensor_map(pl: LruPlan, B: int, T: int, W: int) -> LruMap:
    """The TMA geometry of a, b and the output under ``pl``: dims
    (W, T, B), the byte strides of T and B, a box of tile x steps x 1."""
    return LruMap(dims=(W, T, B), strides=(4 * W, 4 * T * W),
                  box=(pl.tile, pl.steps, 1))


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
        lib.rg_lru_scan_launch.argtypes = [
            vp, vp, vp, vp, i32, i32, i32, ctypes.POINTER(LruPlan),
            ctypes.POINTER(LruMap), vp]
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
    pl = plan(B, T, W, sm_count(a.device),
              aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    tmap = ctypes.byref(tensor_map(pl, B, T, W)) if pl.tma else None
    build.check(_kernels().rg_lru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), B, T, W, ctypes.byref(pl), tmap,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream)),
        "rg_lru_scan")
    rg_lru_scan.launches += 1
    return out


rg_lru_scan.launches = 0
