"""The yardstick: the H100's published peaks, and the FLOPs and bytes
the served model needs, counted from its configuration file alone.

Peaks are NVIDIA's data sheet for the H100 SXM at 700 W: 989 TFLOP/s of
dense bf16 and 3.35 TB/s of HBM.  A FLOP count is the work the
arithmetic needs, 2 a multiply-add, with routed experts counted at
``num_experts_per_tok`` a token (never the capacity buffer the program
fills) and causal attention at the pairs it keeps.  Norms, biases, RoPE
and softmax are left out: under 0.1% of any count here.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

PEAK_BF16_FLOPS = 989e12        # dense bf16, H100 SXM
PEAK_HBM_BYTES = 3.35e12        # HBM3, H100 SXM
BF16 = 2                        # bytes


def model_spec(cfg: dict) -> dict:
    """The configuration file's numbers under short names."""
    D = int(cfg["hidden_size"])
    H = int(cfg["num_attention_heads"])
    spec = {
        "L": int(cfg["num_hidden_layers"]), "D": D, "H": H,
        "KV": int(cfg["num_key_value_heads"]),
        "dh": int(cfg.get("head_dim") or D // H),
        "F": int(cfg["intermediate_size"]), "V": int(cfg["vocab_size"]),
        "tied": bool(cfg["tie_word_embeddings"]),
        "eps": float(cfg["rms_norm_eps"]),
        "theta": float(cfg["rope_theta"]), "moe": None,
    }
    if cfg.get("num_experts"):
        spec["moe"] = {
            "E": int(cfg["num_experts"]),
            "K": int(cfg["num_experts_per_tok"]),
            "de": int(cfg["moe_intermediate_size"]),
            "ds": int(cfg.get("shared_expert_intermediate_size") or 0),
            "cf": float(cfg["assumed"]["moe_capacity_factor"]),
            "norm_topk": bool(cfg.get("norm_topk_prob", False)),
        }
    return spec


def _layer_token_flops(s: dict) -> float:
    """FLOPs of one layer's matmuls for one token, attention scores
    excluded: q, k, v and o projections, then the MLP or the MoE's
    router, top-k experts, shared expert and its gate."""
    D, H, KV, dh = s["D"], s["H"], s["KV"], s["dh"]
    f = 2 * D * (H + 2 * KV) * dh + 2 * H * dh * D
    m = s["moe"]
    if m is None:
        return f + 3 * 2 * D * s["F"]
    f += 2 * D * m["E"] + m["K"] * 3 * 2 * D * m["de"]
    if m["ds"]:
        f += 3 * 2 * D * m["ds"] + 2 * D
    return f


def attention_flops(s: dict, pairs: float) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs, every head."""
    return 4.0 * s["H"] * s["dh"] * pairs


def causal_pairs(P: int) -> int:
    return P * (P + 1) // 2


def prefill_flops(s: dict, P: int) -> float:
    """One request's prefill of ``P`` tokens: every layer over every
    token, causal attention, and the unembedding of the last token only
    (the program's prefill returns the last token's logits)."""
    per_layer = P * _layer_token_flops(s) + attention_flops(
        s, causal_pairs(P))
    return s["L"] * per_layer + 2 * s["D"] * s["V"]


def decode_flops(s: dict, rows: Iterable[int]) -> float:
    """One decode step over the active slots, ``rows`` giving each
    slot's attended cache rows (its length after the new token): every
    layer and the unembedding for each active slot, and attention over
    each slot's rows.  Idle slots the batch carries count nothing."""
    rows = list(rows)
    tok = len(rows) * (s["L"] * _layer_token_flops(s) + 2 * s["D"] * s["V"])
    return tok + s["L"] * attention_flops(s, sum(rows))


def flash_bytes(s: dict, P: int) -> int:
    """One layer's flash call read and written once: q and o of H heads,
    k and v of KV heads, bf16."""
    return 2 * P * s["dh"] * (s["H"] + s["KV"]) * BF16


def flash_bound_s(s: dict, P: int) -> float:
    """The least time one layer's causal flash forward over ``P`` tokens
    can take on the card: its FLOPs at the bf16 peak or its bytes at
    the HBM peak, whichever is longer."""
    return max(attention_flops(s, causal_pairs(P)) / PEAK_BF16_FLOPS,
               flash_bytes(s, P) / PEAK_HBM_BYTES)


def page_bytes(s: dict, max_len: int) -> int:
    """One request's KV page: K and V of every layer at ``max_len`` rows,
    bf16, and each layer's int32 length."""
    return s["L"] * (2 * max_len * s["KV"] * s["dh"] * BF16 + 4)


def install_bound_s(page_kernel_bytes: int, pages: int) -> float:
    """The least time installing ``pages`` pages can take: the bytes
    each page gives the kernel read once and written once at the HBM
    peak."""
    return 2.0 * page_kernel_bytes * pages / PEAK_HBM_BYTES


def weight_count(s: dict) -> int:
    """Parameters held, the configuration's: embedding, head unless
    tied, and each layer's projections, biases, norms and FFN."""
    D, H, KV, dh, L = s["D"], s["H"], s["KV"], s["dh"], s["L"]
    layer = D * (H + 2 * KV) * dh + (H + 2 * KV) * dh + H * dh * D + 2 * D
    m = s["moe"]
    if m is None:
        layer += 3 * D * s["F"]
    else:
        layer += D * m["E"] + m["E"] * 3 * D * m["de"]
        if m["ds"]:
            layer += 3 * D * m["ds"] + D
    n = L * layer + s["V"] * D + D
    return n if s["tied"] else n + s["V"] * D


def share(value: Optional[float]) -> Optional[float]:
    """A fraction as a percentage, None kept."""
    return None if value is None else 100.0 * value


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile over every value: the
    smallest value at or above which lie ``q`` percent of them.  An
    infinite value (a request that failed) counts as missing any
    limit."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]
