"""Modeled per-device HBM traffic (the roofline memory term).

Twin of ``repro/launch/traffic.py``: the same integer arithmetic over a
config and the resolved specs (``repro_torch.sharding.resolve_spec``),
over the port's defs, on any mesh with axis names and sizes
(``AbstractMesh`` needs no process group).  The one difference is the
port's RWKV cache tree, which has no dead ``mix.cm_x`` leaf (ROADMAP
C.3): a decode cell of rwkv6-1.6b models that leaf's bytes less.

Model (per device, per step; all sizes computed from the *actual* resolved
shardings, so replicated tensors are charged fully):

  train:   weights 3R+1W (+grad, +opt state R/W, +master R/W)
           activations: 12x residual-stream + 6x FFN-hidden per layer
           (fwd r/w + bwd r/w + remat re-read, fused elementwise assumed)
           attention: K/V tiles re-read once per live (q,k) tile + O(S) q/o
           logits/CE: 6x logits local bytes; embed gather 3x stream
  prefill: fwd-only factors (4x stream, 2x hidden), + KV-cache write
  decode:  weights 1R + full KV-cache read + 1-token write (KV-bound)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.interop import torch_dtype, tree_flatten
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import for_arch
from repro_torch.sharding import mesh_axes, resolve_spec


def _itemsize(name) -> int:
    return torch_dtype(name).itemsize


def _shards(shape, logical, mesh, rules) -> int:
    spec = resolve_spec(shape, logical, mesh, rules)
    sizes = mesh_axes(mesh)
    n = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            n *= sizes[a]
    return n


def _tree_local_bytes(defs, cfg, mesh, rules) -> int:
    total = 0
    for d in tree_flatten(defs)[0]:
        nbytes = int(np.prod(d.shape)) * _itemsize(d.dtype or cfg.dtype)
        total += nbytes // _shards(d.shape, d.logical, mesh, rules)
    return total


def modeled_bytes(cfg: ModelConfig, shape: ShapeCfg, mesh, rules,
                  kind: str) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    dt = _itemsize(cfg.dtype)
    D = cfg.d_model
    L = cfg.n_layers

    bs = _shards((B, S, D), ("batch", "seq", None), mesh, rules)
    X = B * S * D * dt // bs                      # local residual stream
    defs = T.param_defs(cfg)
    W = _tree_local_bytes(defs, cfg, mesh, rules)

    # FFN hidden local bytes per layer
    if cfg.moe is not None:
        m = cfg.moe
        C = int(B * S * m.top_k * m.capacity_factor / m.n_experts)
        fshape = (m.n_experts, C, m.d_expert)
        flogical = ("experts", None, "d_ff")
        FX = int(np.prod(fshape)) * dt // _shards(fshape, flogical, mesh,
                                                  rules)
        if m.d_shared:
            sshape = (B * S, m.d_shared)
            FX += int(np.prod(sshape)) * dt // _shards(
                sshape, ("batch", "d_ff"), mesh, rules)
    else:
        fshape = (B, S, cfg.d_ff)
        FX = int(np.prod(fshape)) * dt // _shards(
            fshape, ("batch", None, "d_ff"), mesh, rules)

    # attention K/V tile traffic per layer (GQA-aware)
    attn = 0
    if cfg.attention is not None:
        a = cfg.attention
        kv_shape = (B, S, a.n_kv_heads, a.d_head)
        KVb = 2 * int(np.prod(kv_shape)) * dt // _shards(
            kv_shape, ("batch", "kv_seq" if kind != "train" else None,
                       "kv_heads", None), mesh, rules)
        nq = S // min(cfg.attn_chunk, S)
        live_frac = 0.5 if a.window is None else min(
            1.0, a.window / max(S, 1))
        attn = int(KVb * max(1, nq * live_frac))

    n_attn = sum(1 for i in range(L)
                 if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
    n_ffn = L  # every block type has an FFN-class sublayer

    lshape = (B, S, cfg.vocab)
    Lg = int(np.prod(lshape)) * dt // _shards(
        lshape, ("batch", None, "vocab"), mesh, rules)

    out: Dict[str, float] = {}
    if kind == "train":
        opt = for_arch(cfg.arch_id)
        O = _tree_local_bytes(defs, cfg, mesh, rules)  # params-shaped
        sdt = _itemsize(opt.state_dtype)
        opt_bytes = 2 * O * sdt // dt                  # m and v
        grad = O * 4 // dt                             # fp32 grads
        weights = 3 * W + grad + 2 * opt_bytes
        acts = L * 12 * X + n_ffn * 6 * FX + n_attn * 3 * attn
        logits = 6 * Lg + 3 * X
        out["weights"] = float(weights)
        out["activations"] = float(acts)
        out["logits"] = float(logits)
    elif kind == "prefill":
        kv_write = 0
        if cfg.attention is not None:
            a = cfg.attention
            Sbuf = min(S, a.window) if a.window else S
            kvs = (B, Sbuf, a.n_kv_heads, a.d_head)
            kv_itemsize = 1 if cfg.kv_dtype == "int8" else dt
            kv_write = n_attn * 2 * int(np.prod(kvs)) * kv_itemsize // \
                _shards(kvs, ("batch", "kv_seq", "kv_heads", None), mesh,
                        rules)
        weights = W
        acts = L * 4 * X + n_ffn * 2 * FX + n_attn * 1 * attn
        out["weights"] = float(weights)
        out["activations"] = float(acts + kv_write)
        out["logits"] = float(Lg / max(S, 1) * 3)      # last-token only
    else:  # decode
        kv_read = 0
        if cfg.attention is not None:
            a = cfg.attention
            Sbuf = min(S, a.window) if a.window else S
            kvs = (B, Sbuf, a.n_kv_heads, a.d_head)
            kv_itemsize = 1 if cfg.kv_dtype == "int8" else dt
            kv_sh = _shards(kvs, ("batch", "kv_seq", "kv_heads", None),
                            mesh, rules)
            kv_read = n_attn * 2 * int(np.prod(kvs)) * kv_itemsize // kv_sh
            if cfg.kv_dtype == "int8":   # per-(token,head) fp32 scales
                kv_read += n_attn * 2 * int(np.prod(kvs[:3])) * 4 // kv_sh
        # recurrent state r/w for ssm/hybrid blocks
        state_rw = 0
        c_defs = T.cache_defs(cfg, B, 1 if cfg.attention is None else 2)
        if cfg.rwkv is not None or cfg.rglru is not None:
            state_rw = 2 * _tree_local_bytes(c_defs, cfg, mesh, rules)
        xd = (B, 1, D)
        Xd = B * D * dt // _shards(xd, ("batch", None, None), mesh, rules)
        Lgd = B * cfg.vocab * dt // _shards(
            (B, 1, cfg.vocab), ("batch", None, "vocab"), mesh, rules)
        out["weights"] = float(W)
        out["activations"] = float(kv_read + state_rw + L * 8 * Xd)
        out["logits"] = float(3 * Lgd)
    out["total"] = sum(out.values())
    return out
