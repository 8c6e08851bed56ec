"""Shared int8 quantization primitives.

Twin of ``repro/quant.py``: per-tensor max-abs scaling onto a symmetric
int8 grid, with the scale hardened against degenerate inputs:

* an all-zero tensor quantizes to zeros with a finite scale (1/127), so
  dequantization returns exact zeros, not NaN from 0/0;
* NaN and Inf are sanitized (``nan_to_num``, saturating at half the
  float32 range) before the max-abs reduction, so the scale is always
  finite and the dequantized values stay finite (a full-range
  saturation would overflow back to Inf in ``q * scale``).

``quantize_int8`` / ``dequantize_int8`` work on tensors (any device),
``np_quantize_int8`` / ``np_dequantize_int8`` on numpy arrays (the spill
side encodes on the host).  Both round half to even and clip to
[-127, 127], so they give the same bits as each other and as the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

# saturation bound for ±Inf: half of float32 max, so the dequant
# product 127 * (bound / 127) can never round past the finite range
_F32_SAT = float(np.finfo(np.float32).max) / 2


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization.

    Returns ``(q, scale)``: ``q`` int8 and ``scale`` a float32 0-d tensor
    on ``x``'s device, finite for every input."""
    xf = torch.nan_to_num(x.to(torch.float32), nan=0.0, posinf=_F32_SAT,
                          neginf=-_F32_SAT)
    m = xf.abs().max()
    scale = torch.where(m > 0, m, torch.ones_like(m)) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def np_quantize_int8(x: np.ndarray):
    """Numpy twin of :func:`quantize_int8` (host-side spill encode)."""
    xf = np.nan_to_num(np.asarray(x).astype(np.float32), nan=0.0,
                       posinf=_F32_SAT, neginf=-_F32_SAT)
    m = float(np.max(np.abs(xf))) if xf.size else 0.0
    scale = np.float32((m if m > 0 else 1.0) / 127.0)
    q = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
    return q, scale


def np_dequantize_int8(q: np.ndarray, scale, dtype=np.float32):
    return (np.asarray(q).astype(np.float32)
            * np.float32(scale)).astype(dtype)
