"""Block composition for the ``"attn"`` and ``"rec"`` block kinds.

Twin of ``repro/models/transformer.py``: the same param and cache trees
(nested dicts, flattened in sorted-key order), so the reference's
weights and caches carry across leaf for leaf and a packed KV page has
the same bytes on both sides.  Layers are grouped by
``cfg.block_pattern`` (e.g. ``("rec", "rec", "attn")``):
``n_layers // len(pattern)`` pattern groups are stacked (leading axis) as
``groups/b0..b{p-1}``, and the remainder layers are the unstacked
``tail/t0..``.  The groups are applied in a Python loop where the
reference scans; each group's cache is a view into the stacked tensors,
updated in place (attention K/V) or written back (the fresh "len" and
recurrent state).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import torch_dtype, tree_flatten, tree_unflatten
from repro_torch.models.layers import (ParamDef, attention_apply,
                                       attention_cache_defs, attention_defs,
                                       check_supported, mlp_apply, mlp_defs,
                                       rms_norm)
from repro_torch.models.rglru import (rglru_apply, rglru_defs,
                                      rglru_state_defs)


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


# ---------------------------------------------------------------------------
# per-block param/cache definitions
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    ln = ParamDef((cfg.d_model,), (None,), init="zeros")
    if kind == "attn":
        return {"ln1": ln, "attn": attention_defs(cfg), "ln2": ln,
                "ffn": mlp_defs(cfg)}
    if kind == "rec":
        return {"ln1": ln, "rec": rglru_defs(cfg), "ln2": ln,
                "ffn": mlp_defs(cfg)}
    raise ValueError(kind)


def block_cache_defs(cfg: ModelConfig, kind: str, batch: int,
                     max_len: int) -> Dict[str, Any]:
    if kind == "attn":
        return {"attn": attention_cache_defs(cfg, batch, max_len)}
    if kind == "rec":
        return {"rec": rglru_state_defs(cfg, batch)}
    raise ValueError(kind)


def block_apply(cfg: ModelConfig, kind: str, p, x, *, mode: str, pos,
                cache=None):
    """One block of ``kind``. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        o, new = attention_apply(
            cfg, p["attn"], h, mode=mode, pos=pos,
            cache=None if cache is None else cache["attn"])
    elif kind == "rec":
        o, new = rglru_apply(cfg, p["rec"], h, mode=mode,
                             state=None if cache is None else cache["rec"])
    else:
        raise ValueError(kind)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(cfg, p["ffn"], h)
    return x, {kind: new}


# ---------------------------------------------------------------------------
# whole-model parameter / cache trees
# ---------------------------------------------------------------------------

def _stacked(n_groups: int, group: dict) -> dict:
    return _map_defs(lambda d: ParamDef((n_groups,) + d.shape,
                                        ("layers",) + d.logical,
                                        init=d.init, dtype=d.dtype), group)


def _group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's param tree: stacked pattern groups, then the
    unstacked tail."""
    check_supported(cfg)
    n_groups, n_tail = _group_layout(cfg)
    defs: Dict[str, Any] = {
        "emb": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                        init="embed"),
        "final_ln": ParamDef((cfg.d_model,), (None,), init="zeros"),
    }
    if n_groups:
        defs["groups"] = _stacked(n_groups, {
            f"b{i}": block_defs(cfg, k)
            for i, k in enumerate(cfg.block_pattern)})
    if n_tail:
        defs["tail"] = {f"t{i}": block_defs(cfg, cfg.block_pattern[i])
                        for i in range(n_tail)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.vocab, cfg.d_model),
                                   ("vocab", "d_model"))
    return defs


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    check_supported(cfg)
    n_groups, n_tail = _group_layout(cfg)
    defs: Dict[str, Any] = {}
    if n_groups:
        defs["groups"] = _stacked(n_groups, {
            f"b{i}": block_cache_defs(cfg, k, batch, max_len)
            for i, k in enumerate(cfg.block_pattern)})
    if n_tail:
        defs["tail"] = {f"t{i}": block_cache_defs(
            cfg, cfg.block_pattern[i], batch, max_len)
            for i in range(n_tail)}
    return defs


# ---------------------------------------------------------------------------
# materialisation
# ---------------------------------------------------------------------------

def _init_leaf(d: ParamDef, cfg: ModelConfig, gen: torch.Generator,
               device) -> torch.Tensor:
    """The reference's init rules (``transformer.py::_init_leaf``), drawn
    from a torch generator: the same distributions, not the same
    numbers."""
    dt = torch_dtype(d.dtype or cfg.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "lru_lambda":      # a in ~[0.9, 0.999]
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return (-9.0 + (-4.3 + 9.0) * u).to(dt)
    noise = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
    if d.init == "small":
        return (0.01 * noise).to(dt)
    if d.init == "embed":
        return (0.02 * noise).to(dt)
    if d.init == "normal_in":
        fan = d.shape[0]
    elif d.init == "normal":        # all-but-last is fan-in
        fan = max(1, int(np.prod(d.shape[:-1])))
    else:
        raise NotImplementedError(f"init {d.init!r} is not ported yet")
    return (fan ** -0.5 * noise).to(dt)


def tree_init(defs, cfg: ModelConfig, seed: int, device) -> Any:
    """Params for ``defs`` from one ``torch.Generator`` seeded with
    ``seed``, leaves drawn in tree-flatten order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves, spec = tree_flatten(defs)
    return tree_unflatten(spec, [_init_leaf(d, cfg, gen, device)
                                 for d in leaves])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    defs = cache_defs(cfg, batch, max_len)
    return _map_defs(lambda d: torch.zeros(
        d.shape, dtype=torch_dtype(d.dtype or cfg.dtype), device=device),
        defs)


# ---------------------------------------------------------------------------
# forward over the whole stack
# ---------------------------------------------------------------------------

def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _write_into(cache: dict, new: dict) -> None:
    """Copy a block's new cache into its cache tensors (views into the
    stacked tensors for a group), in place: nothing to do for the K/V
    updated in place; "len" and the recurrent state are fresh."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_into(cache[k], v)
        elif cache[k].data_ptr() != v.data_ptr():
            cache[k].copy_(v)


def apply_blocks(cfg: ModelConfig, params, x, *, mode: str, pos,
                 caches: Optional[dict] = None):
    """Run every layer: the stacked groups in a Python loop, then the
    tail.  Returns (x, caches): ``caches`` are the given cache tensors,
    updated in place (None when none were given)."""
    n_groups, n_tail = _group_layout(cfg)
    gcaches = caches.get("groups") if caches else None
    for g in range(n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            b = f"b{i}"
            x, nc = block_apply(cfg, kind, _index(params["groups"][b], g), x,
                                mode=mode, pos=pos,
                                cache=None if gcaches is None
                                else _index(gcaches[b], g))
            if gcaches is not None:
                _write_into(_index(gcaches[b], g), nc)
    tcaches = caches.get("tail") if caches else None
    for i in range(n_tail):
        t = f"t{i}"
        x, nc = block_apply(cfg, cfg.block_pattern[i], params["tail"][t], x,
                            mode=mode, pos=pos,
                            cache=None if tcaches is None else tcaches[t])
        if tcaches is not None:
            _write_into(tcaches[t], nc)
    return x, caches
