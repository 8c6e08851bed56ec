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

Under autograd (grad mode on and an input that requires grad) the call
goes through ``RgLruScan``, a ``torch.autograd.Function``.  Its backward
is itself a linear recurrence, run backwards in time: with ``g`` the
gradient flowing into ``h``, ``g_t = dh_t + a_{t+1} g_{t+1}`` (``a_T``
is 0), so ``g`` is ``rg_lru_scan`` over the flipped
``cat(a[:, 1:], 0)`` and the flipped ``dh``, flipped back (on the card
the same kernel, one launch); then ``db = g``, ``da_t = g_t h_{t-1}``
(``h_{-1}`` is ``h0`` or 0) and ``dh0 = a_0 g_0``.

DTensors (a step sharded over a mesh, ``repro_torch.sharding``) reach
the kernel as each rank's local shards, through ``local_map``: the
recurrence is local along batch and along the width, so ``a``'s Shard(0)
and Shard(2) are kept (``h0`` takes Shard(0) and Shard(1) to match), and
any other placement, a split of time included, is replicated first.

A traced call (``repro_torch.device.traced``: meta or fake tensors, or
a dispatch mode such as a FLOP or memory count on the stack) goes
through the ``torch.library`` op ``repro_torch::rg_lru_scan``, whose
fake version allocates what the kernel route does, the one output, and
whose FLOP formula counts the scan's 2 B T W (a multiply and an add a
step and channel); an untraced call never passes through the
dispatcher.

``plan`` is the kernel's launch rule (channels per CTA, time steps per
stage, ring depth, TMA or cp.async route) and ``tensor_map`` the TMA
geometry it implies; the source note of ``csrc/rg_lru.cu`` explains both.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.device import sm_count, traced
from repro_torch.kernels import build
from repro_torch.sharding import is_dtensor

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


class RgLruScan(torch.autograd.Function):
    """``rg_lru_scan`` under autograd; the backward is the reversed scan
    of the module note."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = _scan(a_next.flip(1), dh.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                            else h0[:, None], h[:, :-1]], dim=1)
        dh0 = None if h0 is None else a[:, 0] * g[:, 0]
        return g * h_prev, g, dh0


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, T, W) float32; h0: (B, W) float32 or None -> h (B, T, W)."""
    _check(a, b, h0)
    if is_dtensor(a):
        return _on_local_shards(a, b, h0)
    if a.device.type not in ("cpu", "cuda") and not traced(a):
        raise ValueError(f"rg_lru_scan runs on cuda or cpu, not {a.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RgLruScan.apply(a, b, h0)
    return _scan(a, b, h0)


def _on_local_shards(a, b, h0):
    """``rg_lru_scan`` of DTensors, run on each rank's shards (module
    note)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    keep = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in a.placements]
    args, pls = (a, b), (keep, keep)
    if h0 is not None:
        args += (h0,)
        pls += ([Shard(1) if p == Shard(2) else p for p in keep],)
    return local_map(rg_lru_scan, out_placements=keep, in_placements=pls,
                     device_mesh=a.device_mesh,
                     redistribute_inputs=True)(*args)


def _scan(a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op when traced (module note), else the kernel on CUDA tensors
    and the plain loop on CPU ones."""
    if traced(a):
        return torch.ops.repro_torch.rg_lru_scan(a, b, h0)
    return _direct(a, b, h0)


def _direct(a: torch.Tensor, b: torch.Tensor,
            h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    if a.device.type == "cpu":
        return rg_lru_scan_torch(a, b, h0)
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


def _register_op() -> None:
    """``repro_torch::rg_lru_scan`` (module note), once a process."""
    if hasattr(torch.ops.repro_torch, "rg_lru_scan"):
        return
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::rg_lru_scan", mutates_args=())
    def op(a: torch.Tensor, b: torch.Tensor,
           h0: Optional[torch.Tensor]) -> torch.Tensor:
        return _direct(a, b, h0)

    @op.register_fake
    def _(a, b, h0):
        return torch.empty_like(a)

    @register_flop_formula(torch.ops.repro_torch.rg_lru_scan)
    def _(a_shape, *_, **__) -> int:
        B, T, W = a_shape
        return 2 * B * T * W


_register_op()
