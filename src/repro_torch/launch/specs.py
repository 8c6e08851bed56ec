"""Meta-tensor stand-ins + shardings for every (arch x shape) cell.

Twin of ``repro/launch/specs.py``: abstract trees of the three entry
points, with no device allocation (tensors on the meta device, where the
reference has ``ShapeDtypeStruct``s)

  train:   train_step(state, batch)
  prefill: prefill(params, batch, caches0)
  decode:  decode(params, batch, caches)      (one new token, full cache)

``train_specs`` and ``serve_specs`` return a ``Specs``: the abstract
trees, their resolved specs (``sharding.resolve_spec``'s tuples, the
reference's ``PartitionSpec`` entries) and their shardings (``(mesh,
placements)`` per leaf, which ``sharding.distribute_tree`` places).
Over an ``AbstractMesh`` nothing needs a process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.interop import torch_dtype
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, for_arch
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES, tree_shardings,
                                  tree_specs)


@dataclasses.dataclass(frozen=True)
class Specs:
    """One entry point's arguments: ``abstract`` (a tuple of meta-tensor
    trees), and ``specs`` and ``shardings`` shaped as it."""
    abstract: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    shardings: Tuple[Any, ...]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_abstract(cfg: ModelConfig, batch: int, seq: int,
                   kind: str) -> Tuple[Dict, Dict]:
    """(abstract, logical) for the input batch tree."""
    i32 = torch.int32
    ab: Dict[str, Any] = {"tokens": _meta((batch, seq), i32)}
    lg: Dict[str, Any] = {"tokens": ("batch", "seq")}
    if kind == "train":
        ab["labels"] = _meta((batch, seq), i32)
        lg["labels"] = ("batch", "seq")
    if cfg.attention is not None and cfg.attention.mrope_sections is not None:
        ab["pos"] = _meta((batch, seq, 3), i32)
        lg["pos"] = ("batch", "seq", None)
    if cfg.vision_stub:
        ab["vision_embeds"] = _meta((batch, seq, cfg.d_model),
                                    torch_dtype(cfg.dtype))
        ab["vision_mask"] = _meta((batch, seq), torch.bool)
        lg["vision_embeds"] = ("batch", "seq", None)
        lg["vision_mask"] = ("batch", "seq")
    return ab, lg


def _cell(trees, mesh, rules) -> Specs:
    """``Specs`` of (abstract, logical) pairs."""
    return Specs(abstract=tuple(ab for ab, _ in trees),
                 specs=tuple(tree_specs(ab, lg, mesh, rules)
                             for ab, lg in trees),
                 shardings=tuple(tree_shardings(ab, lg, mesh, rules)
                                 for ab, lg in trees))


def train_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                optimizer: Optional[AdamW] = None) -> Tuple[Specs, AdamW]:
    """(Specs of ``(state, batch)``, the optimizer) for
    ``train_step(state, batch)``; the optimizer is ``for_arch``'s unless
    one is given."""
    opt = optimizer or for_arch(cfg.arch_id)
    defs = T.param_defs(cfg)
    p_ab = T.tree_abstract(defs, cfg)
    p_lg = T.tree_logical(defs)
    o_ab = opt.init_abstract(p_ab)
    o_lg = {"m": p_lg, "v": p_lg}
    if opt.master_weights:
        o_lg["master"] = p_lg
    b_ab, b_lg = batch_abstract(cfg, shape.global_batch, shape.seq_len,
                                "train")
    state_ab = {"params": p_ab, "opt": o_ab, "step": _meta((), torch.int32)}
    state_lg = {"params": p_lg, "opt": o_lg, "step": ()}
    return _cell([(state_ab, state_lg), (b_ab, b_lg)], mesh,
                 TRAIN_RULES), opt


def serve_specs(cfg: ModelConfig, shape: ShapeCfg, mesh,
                kind: str) -> Specs:
    """Specs of ``(params, batch, caches)`` for prefill or decode (one
    new token against a cache of ``seq_len``)."""
    defs = T.param_defs(cfg)
    seq = shape.seq_len if kind == "prefill" else 1
    b_ab, b_lg = batch_abstract(cfg, shape.global_batch, seq, kind)
    c_defs = T.cache_defs(cfg, shape.global_batch, shape.seq_len)
    return _cell([(T.tree_abstract(defs, cfg), T.tree_logical(defs)),
                  (b_ab, b_lg),
                  (T.tree_abstract(c_defs, cfg), T.tree_logical(c_defs))],
                 mesh, SERVE_RULES)


def with_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=n_layers)
