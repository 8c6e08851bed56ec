"""Gradient compression for a cross-replica reduction.

Twin of ``repro/optim/compression.py``.  Two schemes usable as hooks
around a data-parallel gradient reduction:

* ``bf16``: cast-to-bf16 before all-reduce (2x wire bytes);
* ``int8_ef``: per-tensor max-abs int8 quantisation with error feedback:
  the residual is carried and re-added next step, so the quantisation
  bias telescopes to zero over steps.

The int8 quantizer is ``repro_torch.quant``'s (shared with the KV page
codec); the names below are re-exports.  The codes are the reference's,
byte for byte, on the same gradients.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.interop import tree_flatten, tree_map, tree_unflatten
from repro_torch.quant import dequantize_int8, quantize_int8

__all__ = ["quantize_int8", "dequantize_int8", "EFState", "ef_init",
           "ef_compress", "ef_decompress", "compress_for_allreduce"]


@dataclass(frozen=True)
class EFState:
    residual: Any  # tree matching grads, float32


def ef_init(grads_like: Any) -> EFState:
    return EFState(tree_map(lambda g: torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), grads_like))


def ef_compress(grads: Any, state: EFState):
    """Returns (tree with (q, scale) tuples at leaf slots, new EFState)."""
    g_leaves, spec = tree_flatten(grads)
    r_leaves = tree_flatten(state.residual)[0]
    qs, rs = [], []
    for g, r in zip(g_leaves, r_leaves):
        corrected = g.to(torch.float32) + r
        q, s = quantize_int8(corrected)
        qs.append((q, s))
        rs.append(corrected - dequantize_int8(q, s))
    return tree_unflatten(spec, qs), EFState(tree_unflatten(spec, rs))


def ef_decompress(qtree: Any) -> Any:
    """The (q, scale) leaves of ``ef_compress`` as float32 tensors."""
    return tree_map(lambda qs: dequantize_int8(*qs), qtree)


def compress_for_allreduce(grads: Any, scheme: str, ef_state=None):
    """One-stop hook: returns (wire_tree, decompress_fn, new_ef_state)."""
    if scheme == "none":
        return grads, lambda t: t, ef_state
    if scheme == "bf16":
        wire = tree_map(lambda g: g.to(torch.bfloat16), grads)
        return wire, (lambda t: tree_map(
            lambda g: g.to(torch.float32), t)), ef_state
    if scheme == "int8_ef":
        if ef_state is None:
            raise ValueError("int8_ef needs an EFState (ef_init)")
        qtree, new_state = ef_compress(grads, ef_state)
        return qtree, ef_decompress, new_state
    raise ValueError(scheme)
