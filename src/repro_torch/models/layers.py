"""Attention / MLP / norm / RoPE primitives of the attention blocks.

Twin of ``repro/models/layers.py`` for the ``"attn"`` block: the same
shapes, dtypes and rounding points, written as plain functions over a
params dict of tensors.  Prefill attention goes through
``kernels.flash_attention.flash_attention`` (the CUDA kernel on the card;
on the CPU its plain version, ``attention_chunked``, the reference
model's own prefill attention, re-exported here); decode attention is
``decode_attention``, plain PyTorch, as the reference runs it as XLA.

A config with ``attention.window`` keeps a ring cache of
``min(max_len, window)`` rows: token t lives at row ``t % Sbuf``, so
prefill writes its trailing ``Sbuf`` tokens rolled into place and decode
writes at ``len % Sbuf``, as the reference does.

In place where the reference is functional: ``attention_apply`` writes
prefill and decode K/V into the cache tensors it is given and returns
those same tensors, so a stacked batch cache is updated without a copy.

Not in this slice: MoE, the int8 KV cache, M-RoPE and the vision and
audio stubs.  Configs that need them raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (  # noqa: F401
    NEG_INF, attention_chunked, flash_attention)


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | normal_in | zeros | ones | embed
    dtype: Optional[str] = None  # None => model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError((self.shape, self.logical))


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    if set(cfg.block_pattern) - {"attn", "rec"} or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: only the 'attn' and 'rec' blocks are ported "
            f"so far (no RWKV, no MoE)")
    a = cfg.attention
    if (a is not None and a.mrope_sections is not None) or \
            cfg.kv_dtype == "int8" or cfg.vision_stub or cfg.audio_stub:
        raise NotImplementedError(
            f"{cfg.arch_id}: M-RoPE, int8 KV and the vision/audio stubs "
            f"are not ported yet")


# ---------------------------------------------------------------------------
# norms + activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); pos: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (dh/2,)
    angles = (pos.float()[..., None] * freqs)[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     logit_cap: Optional[float] = None) -> torch.Tensor:
    """One-token attention. q: (B,1,H,dh); caches: (B,S,KV,dh)."""
    B, S, KV, dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = (torch.arange(S, device=q.device)[None, :]
            < cur_len.reshape(-1, 1))[:, None, None, :]     # (B,1,1,S)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, dh)


# ---------------------------------------------------------------------------
# attention block (projections + rope + attend)
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> dict:
    a = cfg.attention
    D, H, KV, dh = cfg.d_model, a.n_heads, a.n_kv_heads, a.d_head
    defs = {
        "wq": ParamDef((D, H, dh), ("d_model", "heads", None),
                       init="normal_in"),
        "wk": ParamDef((D, KV, dh), ("d_model", "kv_heads", None),
                       init="normal_in"),
        "wv": ParamDef((D, KV, dh), ("d_model", "kv_heads", None),
                       init="normal_in"),
        "wo": ParamDef((H, dh, D), ("heads", None, "d_model")),
    }
    if a.qkv_bias:
        defs["bq"] = ParamDef((H, dh), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((KV, dh), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((KV, dh), ("kv_heads", None), init="zeros")
    return defs


def attention_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    mode: str, pos: torch.Tensor,
                    cache: Optional[dict] = None):
    """Returns (out, new_cache); cache = {"k","v": (B,Smax,KV,dh),
    "len": (B,)}.  ``mode`` is "prefill" or "decode".

    Prefill writes K/V into the front of the pre-sized ``cache`` in
    place (a ring cache shorter than the prompt takes its trailing rows,
    rolled); decode writes one row per batch element at its own position,
    in place.  ``new_cache`` holds the same tensors (and a fresh "len")."""
    a = cfg.attention
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if a.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = apply_rope(q, pos, a.rope_theta)
    k = apply_rope(k, pos, a.rope_theta)

    if mode == "prefill":
        o = flash_attention(q, k, v, causal=True, window=a.window,
                            scale=a.softmax_scale, logit_cap=a.logit_cap,
                            chunk=cfg.attn_chunk)
        B, S = k.shape[:2]
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        if cache is not None:
            kc, vc = cache["k"], cache["v"]
            Sbuf = kc.shape[1]
            if Sbuf < S:
                # ring cache: token t lives at row t % Sbuf, so the
                # trailing Sbuf tokens go in rolled by (S - Sbuf) % Sbuf
                shift = (S - Sbuf) % Sbuf
                kc.copy_(torch.roll(k[:, -Sbuf:], -shift, dims=1))
                vc.copy_(torch.roll(v[:, -Sbuf:], -shift, dims=1))
            else:
                kc[:, :S] = k
                vc[:, :S] = v
            new_cache = {"k": kc, "v": vc, "len": lens}
        else:
            new_cache = {"k": k, "v": v, "len": lens}
    elif mode == "decode":
        if cache is None or q.shape[1] != 1:
            raise ValueError("decode takes one token per row and a cache")
        cur = cache["len"]                                  # (B,)
        kc, vc = cache["k"], cache["v"]
        Sbuf = kc.shape[1]
        if a.window is not None and Sbuf <= a.window:
            idx = torch.remainder(cur, Sbuf).long()     # ring cache
        else:
            idx = torch.clamp(cur, max=Sbuf - 1).long()
        rows = torch.arange(k.shape[0], device=x.device)
        kc[rows, idx] = k[:, 0]
        vc[rows, idx] = v[:, 0]
        new_cache = {"k": kc, "v": vc, "len": cur + 1}
        eff = torch.clamp(cur + 1, max=Sbuf)
        o = decode_attention(q, kc, vc, eff, scale=a.softmax_scale,
                             logit_cap=a.logit_cap)
    else:
        raise ValueError(f"mode must be prefill|decode, got {mode!r}")
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out, new_cache


def attention_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    a = cfg.attention
    S = min(max_len, a.window) if a.window is not None else max_len
    kv = ParamDef((batch, S, a.n_kv_heads, a.d_head),
                  ("batch", "kv_seq", "kv_heads", None),
                  dtype=cfg.kv_dtype or None)
    return {"k": kv, "v": kv,
            "len": ParamDef((batch,), ("batch",), init="zeros",
                            dtype="int32")}


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": ParamDef((D, F_), ("d_model", "d_ff")),
        "w3": ParamDef((D, F_), ("d_model", "d_ff")),
        "w2": ParamDef((F_, D), ("d_ff", "d_model")),
    }


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["w1"])
    u = torch.einsum("bsd,df->bsf", x, p["w3"])
    return torch.einsum("bsf,fd->bsd", act_fn(cfg.act)(g) * u, p["w2"])
