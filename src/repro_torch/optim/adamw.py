"""AdamW with configurable state dtype (fp32 / bf16) and optional fp32
master weights.

Twin of ``repro/optim/adamw.py``: the same fields, schedule and update,
over the port's nested dicts of tensors.  The schedule and the bias
corrections are float32 tensors on the step's device, as the reference
computes them; weight decay applies where ``p.ndim >= 2`` on the leaf as
stored, so a stacked (n_groups, D) norm scale is decayed and the 1-D
``final_ln`` is not, as in the reference.

State tree: {"m": tree, "v": tree} plus "master" (float32 copies of the
params) with ``master_weights``.  ``update`` is functional: it returns
new trees and leaves its inputs as they were.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.interop import (torch_dtype, tree_flatten, tree_map,
                                 tree_unflatten)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"     # moments dtype
    master_weights: bool = False     # keep fp32 master copy of bf16 params
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_frac: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warm-up, then cosine decay to ``min_lr_frac``: a
        float32 0-d tensor on ``step``'s device."""
        step = step.to(torch.float32)
        warm = torch.clamp((step + 1.0) / max(1, self.warmup_steps),
                           max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.decay_steps - self.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def init(self, params: Any) -> Any:
        sdt = torch_dtype(self.state_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)
        state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
        if self.master_weights:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    def init_abstract(self, abstract_params: Any) -> Any:
        """``init``'s state tree as meta-device tensors of each leaf's
        shape and dtype: nothing is allocated."""
        sdt = torch_dtype(self.state_dtype)
        meta = lambda dt: lambda p: torch.empty(p.shape, dtype=dt,
                                                device="meta")
        state = {"m": tree_map(meta(sdt), abstract_params),
                 "v": tree_map(meta(sdt), abstract_params)}
        if self.master_weights:
            state["master"] = tree_map(meta(torch.float32), abstract_params)
        return state

    def update(self, params: Any, grads: Any, state: Any,
               step: torch.Tensor):
        """(new_params, new_state) for one step at ``step`` (int32, the
        number of steps taken before this one)."""
        sdt = torch_dtype(self.state_dtype)
        lr = self.schedule(step)
        t = step.to(torch.float32) + 1.0
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        p_leaves, spec = tree_flatten(params)
        g_leaves = tree_flatten(grads)[0]
        m_leaves = tree_flatten(state["m"])[0]
        v_leaves = tree_flatten(state["v"])[0]
        masters = state.get("master")
        w_leaves = tree_flatten(masters)[0] if masters is not None \
            else [None] * len(p_leaves)
        new_p, new_m, new_v, new_w = [], [], [], []
        with torch.no_grad():
            for p, g, m, v, w in zip(p_leaves, g_leaves, m_leaves, v_leaves,
                                     w_leaves):
                g32 = g.to(torch.float32)
                m32 = self.b1 * m.to(torch.float32) + (1 - self.b1) * g32
                v32 = self.b2 * v.to(torch.float32) + \
                    (1 - self.b2) * g32 * g32
                del g32
                base = w if w is not None else p.to(torch.float32)
                upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
                if self.weight_decay and p.ndim >= 2:
                    upd = upd + self.weight_decay * base
                new = base - lr * upd
                del upd
                new_m.append(m32.to(sdt))
                new_v.append(v32.to(sdt))
                new_w.append(new)
                new_p.append(new.to(p.dtype))
        new_state = {"m": tree_unflatten(spec, new_m),
                     "v": tree_unflatten(spec, new_v)}
        if masters is not None:
            new_state["master"] = tree_unflatten(spec, new_w)
        return tree_unflatten(spec, new_p), new_state


def for_arch(arch_id: str, **overrides) -> AdamW:
    """Per-arch optimizer policy: grok-1 uses bf16 moments."""
    kw = dict(overrides)
    if arch_id == "grok-1-314b":
        kw.setdefault("state_dtype", "bfloat16")
    return AdamW(**kw)
