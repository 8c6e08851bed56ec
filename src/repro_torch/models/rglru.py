"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Twin of ``repro/models/rglru.py``: the same params, state and rounding
points.

    x1   = conv1d_causal(W_x x)        (temporal conv, width 4)
    r_t  = sigmoid(W_a x1_t)           (recurrence gate)
    i_t  = sigmoid(W_b x1_t)           (input gate)
    a_t  = exp(-c * r_t * softplus(L))
    h_t  = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x1_t)
    out  = W_o (h * gelu(W_g x))

The causal conv is written as the reference writes it, shifted products
summed (no cuDNN convolution, so TF32 does not enter on the card).
Prefill (T > 1) runs the recurrence through
``kernels.rg_lru.rg_lru_scan(a, bx, h0)`` (the CUDA kernel on the card, a
float32 loop on the CPU) where the reference runs an associative scan
with ``h0`` folded into ``bx[:, 0]``; the two agree to rounding.  Decode
(T == 1) is the reference's elementwise step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rg_lru import rg_lru_scan
from repro_torch.models.layers import ParamDef


def rglru_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    W = cfg.rglru.width or D
    K = cfg.rglru.conv_width
    return {
        "wx": ParamDef((D, W), ("d_model", "rec_width")),
        "wg": ParamDef((D, W), ("d_model", "rec_width")),
        "conv": ParamDef((K, W), ("conv", "rec_width"), init="small"),
        "conv_b": ParamDef((W,), ("rec_width",), init="zeros"),
        "wa": ParamDef((W, W), (None, "rec_width")),
        "wb": ParamDef((W, W), (None, "rec_width")),
        "lam": ParamDef((W,), ("rec_width",), init="lru_lambda"),
        "wo": ParamDef((W, D), ("rec_width", "d_model")),
    }


def rglru_state_defs(cfg: ModelConfig, batch: int) -> dict:
    W = cfg.rglru.width or cfg.d_model
    K = cfg.rglru.conv_width
    return {
        "h": ParamDef((batch, W), ("batch", "rec_width"), dtype="float32"),
        "conv": ParamDef((batch, K - 1, W), ("batch", None, "rec_width")),
    }


def rglru_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                mode: str, state: Optional[dict] = None):
    """x: (B,T,D) -> (out, new_state); ``mode`` is "prefill" or "decode".
    ``new_state`` is {"h": (B,W) f32, "conv": (B,K-1,W)}."""
    g = cfg.rglru
    B, T, D = x.shape
    K = g.conv_width
    x1 = torch.einsum("btd,dw->btw", x, p["wx"])
    gate = torch.einsum("btd,dw->btw", x, p["wg"])

    # causal temporal conv
    if mode == "decode":
        if state is None or T != 1:
            raise ValueError("decode takes one token per row and a state")
        hist = torch.cat([state["conv"], x1], dim=1)          # (B,K,W)
        xc = torch.einsum("bkw,kw->bw", hist, p["conv"])[:, None] \
            + p["conv_b"]
        new_conv = hist[:, 1:]
    elif mode == "prefill":
        pad = torch.zeros((B, K - 1, x1.shape[-1]), dtype=x1.dtype,
                          device=x1.device)
        if state is not None:
            pad = state["conv"]
        hist = torch.cat([pad, x1], dim=1)                    # (B,T+K-1,W)
        xc = sum(hist[:, i:i + T] * p["conv"][i] for i in range(K))
        xc = xc + p["conv_b"]
        new_conv = hist[:, -(K - 1):]
    else:
        raise ValueError(f"mode must be prefill|decode, got {mode!r}")

    r = torch.sigmoid(torch.einsum("btw,wv->btv", xc, p["wa"]).float())
    i = torch.sigmoid(torch.einsum("btw,wv->btv", xc, p["wb"]).float())
    log_a = -g.c * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = beta * (i * xc.float())

    h0 = state["h"] if state is not None else None
    if T == 1:
        hprev = h0 if h0 is not None else torch.zeros_like(bx[:, 0])
        h = (a[:, 0] * hprev + bx[:, 0])[:, None]
    else:
        h = rg_lru_scan(a, bx, h0)

    out = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = torch.einsum("btw,wd->btd", out, p["wo"])
    return out, {"h": h[:, -1], "conv": new_conv}
