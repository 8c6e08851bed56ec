"""RWKV-6 (Finch) block: data-dependent-decay linear recurrence.

Twin of ``repro/models/rwkv.py`` (arXiv:2404.05892): ddlerp token shift
with low-rank data-dependent mixing, per-channel data-dependent decay
``w_t = exp(-exp(w0 + lora(x)))``, bonus ``u``, matrix-valued per-head
state S in R^{dk x dv}:

    y_t = r_t . (S_{t-1} + (u*k_t)^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

Prefill runs the reference's chunked formulation: a Python loop over
time chunks of ``c = min(chunk, T)`` tokens (``T % c == 0``, else
``ValueError``), each parallel within the chunk (an O(c^2) product per
head) with the state carried across chunks; decode (``T == 1``) is the
one-step recurrence.  No TPU kernel exists for RWKV, so this is plain
PyTorch in float32, on every device.

The state tree (C.3 in ROADMAP.md): a layer's cache is
``{"mix": {"S", "tm_x"}, "cm_x"}``, the tree the reference's prefill and
decode produce and consume.  ``rwkv_state_defs`` gives the time-mix part
only; the reference's ``rwkv_state_defs`` also defines a ``cm_x`` under
``mix`` that no block reads or writes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, group_norm_heads


def rwkv_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    r = cfg.rwkv
    H = D // r.head_size
    lw, lm = r.decay_lora, r.mix_lora
    return {
        # time-mix
        "mu_x": ParamDef((D,), (None,), init="small"),
        "mu_rkvwg": ParamDef((5, D), (None, None), init="small"),
        "mix_a": ParamDef((D, 5 * lm), ("d_model", None), init="small"),
        "mix_b": ParamDef((5, lm, D), (None, "lora", None), init="small"),
        "w0": ParamDef((D,), (None,), init="decay"),
        "wa": ParamDef((D, lw), ("d_model", None), init="small"),
        "wb": ParamDef((lw, D), ("lora", None), init="small"),
        "u": ParamDef((H, r.head_size), (None, None), init="small"),
        "wr": ParamDef((D, D), ("d_model", "rec_width")),
        "wk": ParamDef((D, D), ("d_model", "rec_width")),
        "wv": ParamDef((D, D), ("d_model", "rec_width")),
        "wg": ParamDef((D, D), ("d_model", "rec_width")),
        "wo": ParamDef((D, D), ("rec_width", "d_model")),
        "ln_s": ParamDef((D,), (None,), init="ones"),
        "ln_b": ParamDef((D,), (None,), init="zeros"),
        # channel-mix
        "cmu_k": ParamDef((D,), (None,), init="small"),
        "cmu_r": ParamDef((D,), (None,), init="small"),
        "ck": ParamDef((D, cfg.d_ff), ("d_model", "d_ff")),
        "cv": ParamDef((cfg.d_ff, D), ("d_ff", "d_model")),
        "cr": ParamDef((D, D), ("d_model", "rec_width")),
    }


def rwkv_state_defs(cfg: ModelConfig, batch: int) -> dict:
    """The time-mix state: S and the last token (see the module note)."""
    D = cfg.d_model
    hs = cfg.rwkv.head_size
    H = D // hs
    return {
        "S": ParamDef((batch, H, hs, hs), ("batch", None, None, None),
                      dtype="float32"),
        "tm_x": ParamDef((batch, D), ("batch", None)),  # last token, time-mix
    }


def _shifted(x: torch.Tensor, mode: str, last: Optional[torch.Tensor]):
    """The previous token of every position: the carried ``last`` in
    decode; in prefill x shifted by one, position 0 taking ``last`` (or
    zeros without a state)."""
    if mode == "decode":
        return last[:, None]                               # (B,1,D)
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        prev = prev.clone()
        prev[:, 0] = last
    return prev


def _ddlerp(x, sx, p):
    """Data-dependent lerp producing the 5 (r,k,v,w,g) mixed inputs."""
    lm = p["mix_b"].shape[1]
    base = x + sx * p["mu_x"]
    low = torch.tanh(torch.einsum("btd,dl->btl", base, p["mix_a"]))
    low = low.reshape(*low.shape[:-1], 5, lm)
    dyn = torch.einsum("btil,ild->ibtd", low, p["mix_b"])
    mus = p["mu_rkvwg"][:, None, None, :]
    return x[None] + sx[None] * (mus + dyn)               # (5, B, T, D)


def _wkv_chunk(S0, r, k, v, w, u):
    """One chunk of the wkv recurrence, parallel within the chunk.

    r,k,v,w: (B, T, H, hs) fp32; S0: (B, H, hs, hs) fp32.
    Returns (y (B,T,H,hs), S1).
    """
    B, T, H, hs = r.shape
    logw = torch.log(w)                                    # (B,T,H,hs), <0
    cum = torch.cumsum(logw, dim=1)                        # inclusive
    # contribution of the carried-in state: decay up to t-1 => cum - logw
    dec_in = torch.exp(cum - logw)
    y_state = torch.einsum("bthk,bhkv->bthv", r * dec_in, S0)
    # intra-chunk: pair (t, s<t) decays by exp(cum_{t-1} - cum_s), plus
    # the diagonal bonus u at s == t.  Both exp factors are shifted by the
    # chunk-midpoint cumulative decay and clamped to [-60, 60] so their
    # product never overflows: where a factor clamps the true decay is
    # exp(<-60) ~ 0 anyway.
    shift = cum[:, T // 2][:, None]                        # (B,1,H,hs)
    f_t = torch.exp(torch.clamp(cum - logw - shift, -60.0, 60.0))
    f_s = torch.exp(torch.clamp(shift - cum, -60.0, 60.0))
    att = torch.einsum("bthk,bshk->bhts", r * f_t, k * f_s)
    idx = torch.arange(T, device=r.device)
    att = torch.where((idx[None, :] < idx[:, None])[None, None], att, 0.0)
    diag = torch.einsum("bthk,bthk->bth", r, u[None, None] * k)
    y_intra = torch.einsum("bhts,bshv->bthv", att, v)
    y_intra = y_intra + diag[..., None] * v
    # state update: S1 = exp(cum_T) S0 + sum_s exp(cum_T - cum_s) k_s^T v_s
    dec_all = torch.exp(cum[:, -1])                        # (B,H,hs)
    S1 = dec_all[..., None] * S0 + torch.einsum(
        "bshk,bshv->bhkv", k * torch.exp(cum[:, -1:] - cum), v)
    return y_state + y_intra, S1


def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                  mode: str, state: Optional[dict], chunk: int = 128):
    """Returns (out, new_state {"S", "tm_x"})."""
    B, T, D = x.shape
    hs = cfg.rwkv.head_size
    H = D // hs

    sx = _shifted(x, mode, None if state is None else state["tm_x"]) - x
    xr, xk, xv, xw, xg = _ddlerp(x, sx, p)

    r = torch.einsum("btd,de->bte", xr, p["wr"])
    k = torch.einsum("btd,de->bte", xk, p["wk"])
    v = torch.einsum("btd,de->bte", xv, p["wv"])
    g = F.silu(torch.einsum("btd,de->bte", xg, p["wg"]))
    dw = torch.einsum("btd,dl->btl", torch.tanh(xw @ p["wa"]), p["wb"])
    w = torch.exp(-torch.exp((p["w0"] + dw).float()))
    w = w.reshape(B, T, H, hs)

    rf, kf, vf = (t.float().reshape(B, T, H, hs) for t in (r, k, v))
    u = p["u"].float()
    S0 = state["S"] if state is not None else torch.zeros(
        (B, H, hs, hs), dtype=torch.float32, device=x.device)
    if T == 1:
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, 0], vf[:, 0])
        y = torch.einsum("bhk,bhkv->bhv", rf[:, 0],
                         S0 + u[None, :, :, None] * kv)[:, None]
        S1 = w[:, 0][..., None] * S0 + kv
    else:
        c = min(chunk, T)
        if T % c:
            raise ValueError(f"rwkv prefill of {T} tokens: the length must "
                             f"be a multiple of the chunk {c}")
        ys, S1 = [], S0
        for i in range(T // c):
            sl = slice(i * c, (i + 1) * c)
            yi, S1 = _wkv_chunk(S1, rf[:, sl], kf[:, sl], vf[:, sl],
                                w[:, sl], u)
            ys.append(yi)
        y = torch.cat(ys, dim=1)

    y = group_norm_heads(y.to(x.dtype), p["ln_s"].reshape(H, hs),
                         p["ln_b"].reshape(H, hs), cfg.norm_eps)
    y = y.reshape(B, T, D) * g
    out = torch.einsum("btd,de->bte", y, p["wo"])
    return out, {"S": S1, "tm_x": x[:, -1]}


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                     mode: str, state: Optional[dict]):
    """Returns (out, cm_x): the last token is the channel-mix state."""
    sx = _shifted(x, mode, None if state is None else state["cm_x"]) - x
    xk = x + sx * p["cmu_k"]
    xr = x + sx * p["cmu_r"]
    k = torch.square(F.relu(torch.einsum("btd,df->btf", xk, p["ck"])))
    v = torch.einsum("btf,fd->btd", k, p["cv"])
    r = torch.sigmoid(torch.einsum("btd,de->bte", xr, p["cr"]))
    return r * v, x[:, -1]
