"""Attention / MLP / norm / RoPE primitives shared by every block kind.

Twin of ``repro/models/layers.py``: the same shapes, dtypes and rounding
points, written as plain functions over a params dict of tensors.
Prefill attention goes through
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
On a cache of DTensors (a sharded decode, ``launch/dryrun.py``'s serve
cells) each rank writes the new rows into its own shard
(``_write_rows``): DTensor has no strategy for an indexed write into a
tensor sharded along the indexed dims.

M-RoPE (``attention.mrope_sections``, qwen2-vl) rotates each band of
rotary pairs by its own position stream; positions are then (B, S, 3).
The int8 KV cache (``ModelConfig.kv_dtype == "int8"``) stores K and V as
per-(token, head) symmetric int8 beside float32 ``k_scale``/``v_scale``
leaves: prefill attends over the unquantised K/V (so the flash kernel
still runs in the model dtype) and only the cache holds int8; decode
quantises the new row and attends over the dequantised cache, as the
reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import (  # noqa: F401
    NEG_INF, attention_chunked, flash_attention)
from repro_torch.sharding import for_compute, is_dtensor


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | normal_in | normal1 | zeros |
    #                            ones | small | embed | decay | lru_lambda
    dtype: Optional[str] = None  # None => model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError((self.shape, self.logical))


BLOCK_KINDS = ("attn", "rec", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind that no model of either
    package has; every other config runs."""
    unknown = set(cfg.block_pattern) - set(BLOCK_KINDS)
    if unknown:
        raise ValueError(f"{cfg.arch_id}: unknown block kinds "
                         f"{sorted(unknown)} (known: {BLOCK_KINDS})")


# ---------------------------------------------------------------------------
# norms + activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head LayerNorm used by RWKV wkv output. x: (..., H, dh)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None
               ) -> torch.Tensor:
    """x: (B, S, H, dh); pos: (B, S), or (B, S, 3) for M-RoPE."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)            # (dh/2,)
    if mrope_sections is not None:
        # M-RoPE: the rotary pairs split into (t, h, w) bands; each band
        # rotates by its own position stream
        if pos.ndim != 3 or pos.shape[-1] != 3:
            raise ValueError(f"M-RoPE takes (B, S, 3) positions, got "
                             f"{tuple(pos.shape)}")
        sec = torch.cumsum(torch.tensor((0,) + tuple(mrope_sections),
                                        device=x.device), 0)
        band = torch.searchsorted(sec[1:], torch.arange(
            d_head // 2, device=x.device), right=True).clamp(0, 2)
        angles = (pos.float()[..., band] * freqs)[:, :, None, :]
    else:
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
    qg = _whole_groups(q, KV).reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    mask = (torch.arange(S, device=q.device)[None, :]
            < cur_len.reshape(-1, 1))[:, None, None, :]     # (B,1,1,S)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, dh)


def _write_rows(buf: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> None:
    """``buf[b, idx[b]] = val[b]`` for every batch row b, in place.  On
    a DTensor ``buf`` (batch, positions and heads sharded) each rank
    writes its own batch rows whose position lies in its slice of the
    positions and leaves the others as they were."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    if not is_dtensor(buf):
        buf[rows, idx] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pb = buf.device_mesh, list(buf.placements)
    coord, shard = mesh.get_coordinate(), 0
    for j, p in enumerate(pb):
        if p == Shard(1):   # this rank's slice of the positions, in order
            shard = shard * mesh.size(j) + coord[j]
    p_idx = [p if p == Shard(0) else Replicate() for p in pb]
    p_val = [p if p == Shard(0) else Shard(p.dim - 1)
             if isinstance(p, Shard) and p.dim >= 2 else Replicate()
             for p in pb]

    def write(b, i, v):
        n = b.shape[1]
        at = i - shard * n
        mine = ((at >= 0) & (at < n)).reshape((-1,) + (1,) * (v.ndim - 1))
        at = torch.clamp(at, 0, n - 1)
        r = torch.arange(b.shape[0], device=b.device)
        b[r, at] = torch.where(mine, v, b[r, at])
        return b

    local_map(write, out_placements=pb, in_placements=(pb, p_idx, p_val),
              device_mesh=mesh, redistribute_inputs=True)(buf, idx, val)


def _whole_groups(q: torch.Tensor, KV: int) -> torch.Tensor:
    """q (B, T, H, dh) as it can be grouped into (KV, H // KV): on a
    DTensor its heads stay split over the mesh dims that split the KV
    heads evenly (whole GQA groups a rank, as the flash wrapper keeps
    them) and are gathered over the others, where DTensor could not
    unflatten them (llama3-8b's 8 KV heads on 16); any other q as it
    is."""
    if not is_dtensor(q):
        return q
    from torch.distributed.tensor import Replicate, Shard
    mesh, n, want = q.device_mesh, 1, []
    for j, p in enumerate(q.placements):
        if p == Shard(2) and KV % (n * mesh.size(j)) == 0:
            n *= mesh.size(j)
        elif p == Shard(2):
            p = Replicate()
        want.append(p)
    return q if want == list(q.placements) else q.redistribute(mesh, want)


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
    "len": (B,)}, plus "k_scale","v_scale": (B,Smax,KV) float32 with the
    int8 KV cache.  ``mode`` is "train", "prefill" or "decode".

    Prefill writes K/V into the front of the pre-sized ``cache`` in
    place (a ring cache shorter than the prompt takes its trailing rows,
    rolled); decode writes one row per batch element at its own position,
    in place.  ``new_cache`` holds the same tensors (and a fresh "len").
    Train attends as prefill does (the flash call, under autograd) and
    keeps no cache: ``new_cache`` is None."""
    a = cfg.attention
    q = torch.einsum("bsd,dhk->bshk", x, for_compute(p["wq"], 1))
    k = torch.einsum("bsd,dhk->bshk", x, for_compute(p["wk"], 1))
    v = torch.einsum("bsd,dhk->bshk", x, for_compute(p["wv"], 1))
    if a.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if a.mrope_sections is not None and pos.ndim == 2:
        pos = pos[..., None].expand(*pos.shape, 3)
    q = apply_rope(q, pos, a.rope_theta, a.mrope_sections)
    k = apply_rope(k, pos, a.rope_theta, a.mrope_sections)

    kv_int8 = cfg.kv_dtype == "int8"
    if mode in ("train", "prefill"):
        o = flash_attention(q, k, v, causal=True, window=a.window,
                            scale=a.softmax_scale, logit_cap=a.logit_cap,
                            chunk=cfg.attn_chunk)
    if mode == "train":
        new_cache = None
    elif mode == "prefill":
        B, S = k.shape[:2]
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        # what the cache stores: K/V, or their int8 codes and scales
        store = {"k": k, "v": v}
        if kv_int8:
            store["k"], store["k_scale"] = _kv_quantize(k)
            store["v"], store["v_scale"] = _kv_quantize(v)
        if cache is not None:
            Sbuf = cache["k"].shape[1]
            for name, t in store.items():
                buf = cache[name]
                if Sbuf < S:
                    # ring cache: token t lives at row t % Sbuf, so the
                    # trailing Sbuf tokens go in rolled by (S - Sbuf) % Sbuf
                    shift = (S - Sbuf) % Sbuf
                    buf.copy_(torch.roll(t[:, -Sbuf:], -shift, dims=1))
                else:
                    buf[:, :S] = t
                store[name] = buf
        new_cache = dict(store, len=lens)
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
        new_cache = {"k": kc, "v": vc, "len": cur + 1}
        if kv_int8:
            kq, k_sc = _kv_quantize(k)
            vq, v_sc = _kv_quantize(v)
            _write_rows(kc, idx, kq[:, 0])
            _write_rows(vc, idx, vq[:, 0])
            _write_rows(cache["k_scale"], idx, k_sc[:, 0])
            _write_rows(cache["v_scale"], idx, v_sc[:, 0])
            new_cache.update(k_scale=cache["k_scale"],
                             v_scale=cache["v_scale"])
            kd = _kv_dequantize(kc, cache["k_scale"], x.dtype)
            vd = _kv_dequantize(vc, cache["v_scale"], x.dtype)
        else:
            _write_rows(kc, idx, k[:, 0])
            _write_rows(vc, idx, v[:, 0])
            kd, vd = kc, vc
        eff = torch.clamp(cur + 1, max=Sbuf)
        o = decode_attention(q, kd, vd, eff, scale=a.softmax_scale,
                             logit_cap=a.logit_cap)
    else:
        raise ValueError(f"mode must be train|prefill|decode, got {mode!r}")
    out = torch.einsum("bshk,hkd->bsd", o, for_compute(p["wo"], 0))
    return out, new_cache


def attention_cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    a = cfg.attention
    S = min(max_len, a.window) if a.window is not None else max_len
    kv = ParamDef((batch, S, a.n_kv_heads, a.d_head),
                  ("batch", "kv_seq", "kv_heads", None),
                  dtype=cfg.kv_dtype or None)
    defs = {"k": kv, "v": kv,
            "len": ParamDef((batch,), ("batch",), init="zeros",
                            dtype="int32")}
    if cfg.kv_dtype == "int8":
        sc = ParamDef((batch, S, a.n_kv_heads),
                      ("batch", "kv_seq", "kv_heads"), init="ones",
                      dtype="float32")
        defs["k_scale"] = sc
        defs["v_scale"] = sc
    return defs


def _kv_quantize(t: torch.Tensor):
    """Per-(token, head) symmetric int8. t: (B,S,KV,dh)."""
    tf = t.float()
    scale = torch.clamp(torch.amax(torch.abs(tf), dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


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
    g = torch.einsum("bsd,df->bsf", x, for_compute(p["w1"], 1))
    u = torch.einsum("bsd,df->bsf", x, for_compute(p["w3"], 1))
    return torch.einsum("bsf,fd->bsd", act_fn(cfg.act)(g) * u,
                        for_compute(p["w2"], 0))
