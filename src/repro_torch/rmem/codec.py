"""Per-page codecs for the tier boundary.

Twin of ``repro/rmem/codec.py``.  A :class:`PageCodec` maps a *logical*
page (the bytes the serving layer sees: typed leaf segments in
``PageLayout`` order) to a *physical* stored representation and back.
Encoding runs on the host, on the spill path; decoding runs on the host
(single-page reads, delta pages) or on the device, before the install
(``kernels/page_install.install_pages(codec=...)``).

Formats: the encoded layout is static.  Segment order is kept and every
encoded segment has a fixed byte width, so fetch groups stay fixed-stride
arrays:

* ``none``: identity (``make_codec`` returns None).
* ``bf16``: float32 segments cast to bfloat16 (2x); bf16, f16 and
  non-float segments pass through raw (lossless by construction).
* ``int8``: float segments become ``[4-byte f32 max-abs scale][one int8
  per element]`` (``repro_torch.quant``); non-float segments raw.

The host side needs no bfloat16 numpy dtype: bf16 values travel as their
uint16 bits, widened to float32 by a 16-bit shift (exact) and narrowed by
round-to-nearest-even on the bits, with NaN written as its sign and
``0x7fc0``: the bytes the reference's ``ml_dtypes`` casts give.

Cross-request prefix sharing stores *deltas* against a shared base page:
:func:`delta_encode` emits a block bitmap plus only the blocks that
differ from the base (both already codec-encoded), and :func:`delta_apply`
rebuilds the exact encoded bytes, so sharing is bit-transparent under any
codec.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.interop import dtype_name, torch_dtype
from repro_torch.quant import (dequantize_int8, np_dequantize_int8,
                               np_quantize_int8)

_FLOAT_NAMES = ("float32", "bfloat16", "float16")
DELTA_BLOCK = 64


def _name(dt) -> str:
    return dt if isinstance(dt, str) else dtype_name(dt)


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32 values, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16) \
        .view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values -> bfloat16 bits (uint16), round to nearest even;
    NaN becomes its sign | 0x7fc0."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000) | 0x7FC0
    return out


def _np_floats(raw: np.ndarray, name: str) -> np.ndarray:
    """A float segment's bytes as its values (float32 for bf16)."""
    if name == "bfloat16":
        return bf16_bits_to_f32(raw.view(np.uint16))
    return raw.view(np.dtype(name))


def _np_narrow(vals: np.ndarray, name: str) -> np.ndarray:
    """float32 values as the bytes of a ``name`` segment."""
    if name == "bfloat16":
        return f32_to_bf16_bits(vals).view(np.uint8)
    return vals.astype(np.dtype(name)).view(np.uint8)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One typed extent of the logical page (mirrors a layout leaf)."""
    offset: int
    nbytes: int
    dtype: str


@dataclasses.dataclass(frozen=True)
class EncSeg:
    """A segment plus its position and format in the encoded page."""
    offset: int        # logical byte offset
    nbytes: int        # logical bytes
    dtype: str         # logical element dtype
    kind: str          # "raw" | "cast" (f32->bf16) | "quant" (int8+scale)
    enc_offset: int    # encoded byte offset
    enc_nbytes: int    # encoded bytes


def _seg_kind(name: str, dtype: str, nbytes: int) -> Tuple[str, int]:
    if name == "bf16" and dtype == "float32":
        return "cast", nbytes // 2
    if name == "int8" and dtype in _FLOAT_NAMES:
        return "quant", 4 + nbytes // _itemsize(dtype)
    return "raw", nbytes


@dataclasses.dataclass(frozen=True)
class PageCodec:
    """Static logical <-> encoded page mapping (hashable: keys caches)."""
    name: str
    page_bytes: int
    segs: Tuple[EncSeg, ...]

    @property
    def encoded_bytes(self) -> int:
        last = self.segs[-1]
        return last.enc_offset + last.enc_nbytes

    def seg_at(self, offset: int) -> Optional[EncSeg]:
        for s in self.segs:
            if s.offset == offset:
                return s
        return None

    # -- host side (numpy) ------------------------------------------------
    def encode(self, raw) -> np.ndarray:
        """Logical page bytes -> encoded bytes (both 1-D uint8)."""
        raw = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
        if raw.nbytes != self.page_bytes:
            raise ValueError(f"page is {raw.nbytes}B, codec expects "
                             f"{self.page_bytes}B")
        out = np.empty((self.encoded_bytes,), np.uint8)
        for s in self.segs:
            src = raw[s.offset:s.offset + s.nbytes]
            dst = out[s.enc_offset:s.enc_offset + s.enc_nbytes]
            if s.kind == "raw":
                dst[:] = src
            elif s.kind == "cast":
                dst[:] = f32_to_bf16_bits(src.view(np.float32)) \
                    .view(np.uint8)
            else:  # quant
                q, scale = np_quantize_int8(_np_floats(src, s.dtype))
                dst[:4] = np.float32(scale).reshape(1).view(np.uint8)
                dst[4:] = q.view(np.uint8)
        return out

    def decode(self, enc) -> np.ndarray:
        """Encoded bytes -> logical page bytes (both 1-D uint8)."""
        enc = np.ascontiguousarray(enc).reshape(-1).view(np.uint8)
        enc = enc[:self.encoded_bytes]
        out = np.empty((self.page_bytes,), np.uint8)
        for s in self.segs:
            src = enc[s.enc_offset:s.enc_offset + s.enc_nbytes]
            dst = out[s.offset:s.offset + s.nbytes]
            if s.kind == "raw":
                dst[:] = src
            elif s.kind == "cast":
                dst[:] = bf16_bits_to_f32(src.view(np.uint16)) \
                    .view(np.uint8)
            else:  # quant
                deq = np_dequantize_int8(src[4:].view(np.int8),
                                         src[:4].view(np.float32)[0])
                dst[:] = _np_narrow(deq, s.dtype)
        return out

    # -- device side (torch, on the row's device) -------------------------
    def decode_segment(self, enc: torch.Tensor,
                       seg: EncSeg) -> torch.Tensor:
        """Decode one segment of encoded uint8 rows ``(..., encoded_bytes)``
        to its typed values ``(..., n)`` in the segment's logical dtype,
        on ``enc``'s device.  Slices are cloned before a wider view: an
        encoded offset need not be aligned."""
        dt = torch_dtype(seg.dtype)
        by = enc[..., seg.enc_offset:seg.enc_offset + seg.enc_nbytes]
        if seg.kind == "raw":
            return by if dt == torch.uint8 else by.clone().view(dt)
        if seg.kind == "cast":
            return by.clone().view(torch.bfloat16).to(torch.float32)
        return dequantize_int8(by[..., 4:].view(torch.int8),
                               by[..., :4].clone().view(torch.float32), dt)

    def decode_row(self, enc: torch.Tensor) -> torch.Tensor:
        """Encoded uint8 rows ``(..., encoded_bytes)`` -> logical uint8
        rows ``(..., page_bytes)``, on ``enc``'s device."""
        parts = [self.decode_segment(enc, s).view(torch.uint8)
                 for s in self.segs]
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def make_codec(name: Optional[str], page_bytes: int,
               segments: Optional[Sequence[Segment]] = None,
               dtype: str = "uint8") -> Optional[PageCodec]:
    """Build a codec; ``None`` / ``"none"`` -> no codec (identity tier)."""
    if name is None or name == "none":
        return None
    if name not in ("bf16", "int8"):
        raise ValueError(f"unknown codec {name!r}")
    if segments is None:
        segments = [Segment(0, page_bytes, _name(dtype))]
    segs, enc_off, want = [], 0, 0
    for sg in sorted(segments, key=lambda s: s.offset):
        dt = _name(sg.dtype)
        if sg.offset != want:
            raise ValueError("codec segments must tile the page "
                             f"contiguously (gap at byte {want})")
        if sg.nbytes % _itemsize(dt):
            raise ValueError(f"segment at {sg.offset} is not a whole "
                             f"number of {dt} elements")
        kind, enc_n = _seg_kind(name, dt, sg.nbytes)
        segs.append(EncSeg(sg.offset, sg.nbytes, dt, kind, enc_off, enc_n))
        enc_off += enc_n
        want = sg.offset + sg.nbytes
    if want != page_bytes:
        raise ValueError(f"segments cover {want}B of a {page_bytes}B page")
    return PageCodec(name, page_bytes, tuple(segs))


@functools.lru_cache(maxsize=None)
def row_decoder(codec: PageCodec, dtype: str,
                page_shape: Tuple[int, ...]):
    """``(staged_group, row) -> typed page``: decodes one encoded row of a
    device-staged fetch group into the store's page dtype and shape (the
    lazy slot's first-touch decode)."""
    dt = torch_dtype(dtype)

    def fn(group: torch.Tensor, row: int) -> torch.Tensor:
        by = codec.decode_row(group[row])
        if dt != torch.uint8:
            by = by.view(dt)
        return by.reshape(page_shape)
    return fn


# -- block deltas for shared-prefix pages ---------------------------------

def delta_encode(base: np.ndarray, new: np.ndarray,
                 block: int = DELTA_BLOCK) -> np.ndarray:
    """Bitmap + changed blocks of ``new`` against ``base`` (equal-length
    encoded pages).  Always decodable with :func:`delta_apply` given the
    base; the caller only stores it when it is smaller."""
    base = np.ascontiguousarray(base).view(np.uint8).reshape(-1)
    new = np.ascontiguousarray(new).view(np.uint8).reshape(-1)
    if base.nbytes != new.nbytes:
        raise ValueError("delta requires equal-length encoded pages")
    n = new.nbytes
    nb = (n + block - 1) // block
    pad = nb * block - n
    b2 = np.pad(base, (0, pad)).reshape(nb, block)
    n2 = np.pad(new, (0, pad)).reshape(nb, block)
    changed = np.any(b2 != n2, axis=1)
    bitmap = np.packbits(changed)
    return np.concatenate([bitmap, n2[changed].reshape(-1)])


def delta_apply(base: np.ndarray, delta: np.ndarray,
                block: int = DELTA_BLOCK) -> np.ndarray:
    base = np.ascontiguousarray(base).view(np.uint8).reshape(-1)
    delta = np.ascontiguousarray(delta).view(np.uint8).reshape(-1)
    n = base.nbytes
    nb = (n + block - 1) // block
    head = (nb + 7) // 8
    changed = np.unpackbits(delta[:head])[:nb].astype(bool)
    pad = nb * block - n
    out = np.pad(base, (0, pad)).reshape(nb, block).copy()
    payload = delta[head:head + int(changed.sum()) * block]
    out[changed] = payload.reshape(-1, block)
    return out.reshape(-1)[:n]
