"""Block composition for the ``block_pattern=("attn",)`` family.

Twin of ``repro/models/transformer.py``: the same param and cache trees
(nested dicts, flattened in sorted-key order), so the reference's
weights and caches carry across leaf for leaf and a packed KV page has
the same bytes on both sides.  The stacked layer groups (leading axis)
are applied in a Python loop where the reference scans; each group's
cache is a view into the stacked tensors, which ``attention_apply``
updates in place.  Block kinds other than ``"attn"`` raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import torch_dtype, tree_flatten, tree_unflatten
from repro_torch.models.layers import (ParamDef, attention_apply,
                                       attention_cache_defs, attention_defs,
                                       check_supported, mlp_apply, mlp_defs,
                                       rms_norm)


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


# ---------------------------------------------------------------------------
# per-block param/cache definitions
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    ln = ParamDef((cfg.d_model,), (None,), init="zeros")
    return {"ln1": ln, "attn": attention_defs(cfg), "ln2": ln,
            "ffn": mlp_defs(cfg)}


def block_cache_defs(cfg: ModelConfig, batch: int,
                     max_len: int) -> Dict[str, Any]:
    return {"attn": attention_cache_defs(cfg, batch, max_len)}


def block_apply(cfg: ModelConfig, p, x, *, mode: str, pos, cache=None):
    """One "attn" block. Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, new_attn = attention_apply(
        cfg, p["attn"], h, mode=mode, pos=pos,
        cache=None if cache is None else cache["attn"])
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(cfg, p["ffn"], h)
    return x, {"attn": new_attn}


# ---------------------------------------------------------------------------
# whole-model parameter / cache trees
# ---------------------------------------------------------------------------

def _stacked(n_groups: int, group: dict) -> dict:
    return _map_defs(lambda d: ParamDef((n_groups,) + d.shape,
                                        ("layers",) + d.logical,
                                        init=d.init, dtype=d.dtype), group)


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's param tree.  With ``block_pattern=("attn",)`` every
    layer is one stacked group (leading axis ``n_layers``) and there is
    no tail."""
    check_supported(cfg)
    defs: Dict[str, Any] = {
        "emb": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                        init="embed"),
        "final_ln": ParamDef((cfg.d_model,), (None,), init="zeros"),
        "groups": _stacked(cfg.n_layers, {"b0": block_defs(cfg)}),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.vocab, cfg.d_model),
                                   ("vocab", "d_model"))
    return defs


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    check_supported(cfg)
    return {"groups": _stacked(cfg.n_layers, {
        "b0": block_cache_defs(cfg, batch, max_len)})}


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
    noise = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
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


def _write_back(stacked: dict, g: int, new: dict) -> None:
    """Store group ``g``'s new cache into the stacked tensors (a no-op
    copy for the K/V views updated in place; "len" is fresh)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(stacked[k], g, v)
        elif stacked[k][g].data_ptr() != v.data_ptr():
            stacked[k][g] = v


def apply_blocks(cfg: ModelConfig, params, x, *, mode: str, pos,
                 caches: Optional[dict] = None):
    """Run every layer (a Python loop over the stacked groups). Returns
    (x, caches): ``caches`` are the given cache tensors, updated in place
    (None when none were given)."""
    gcaches = caches["groups"]["b0"] if caches else None
    for g in range(cfg.n_layers):
        x, nc = block_apply(cfg, _index(params["groups"]["b0"], g), x,
                            mode=mode, pos=pos,
                            cache=None if gcaches is None
                            else _index(gcaches, g))
        if gcaches is not None:
            _write_back(gcaches, g, nc)
    return x, caches
