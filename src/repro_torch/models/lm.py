"""LM-level glue: embedding, forward, loss, and the step builders.

``batch`` dicts use the reference's keys:
  train/prefill: {"tokens": (B,S) int32, "labels": (B,S) int32 (train
            only), "loss_mask": (B,S) (train, optional), "pos": (B,S) or
            (B,S,3) int32 (optional), "vision_embeds": (B,S,D),
            "vision_mask": (B,S) bool (the vision stub, optional)}
  decode:  {"tokens": (B,1) int32, "pos": (B,1) or (B,1,3) int32}

(B, S, 3) positions are M-RoPE's (t, h, w) streams; ``attention_apply``
broadcasts (B, S) ones to all three (text tokens).  The vision stub
(qwen2-vl) takes precomputed patch embeddings in place of the token
embeddings where ``vision_mask`` is set; the audio stub (musicgen) has
no model code: the backbone reads codec token ids as any vocabulary.

Training (``loss_fn``, ``make_train_step``) differentiates with
autograd, where the reference takes ``jax.value_and_grad``; the flash
and rg_lru kernels run under it through their ``autograd.Function``s.

``ctx`` is a ``repro_torch.sharding.ShardCtx``, taken where the
reference takes it: with one, params and batch are DTensors over its
mesh (``launch/specs.py`` places them), the constraints below
redistribute the activations as the reference's pin them, and the
kernels run on each rank's local shards.  Without one, every
``constrain`` is a no-op.  The reference's unrolled cost path belongs
to the dry run (ROADMAP A.8) and is not taken here.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import tree_flatten, tree_unflatten
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import apply_blocks
from repro_torch.sharding import (as_placed, constrain, full, is_dtensor,
                                  placed_as, scope)


def embed(cfg: ModelConfig, params, batch: Dict[str, Any]) -> torch.Tensor:
    emb, tok = params["emb"], batch["tokens"].long()
    x = _lookup(emb, tok) if is_dtensor(emb) else emb[tok]
    if cfg.vision_stub and batch.get("vision_embeds") is not None:
        x = torch.where(batch["vision_mask"][..., None],
                        batch["vision_embeds"].to(x.dtype), x)
    return x


def _lookup(emb, tok):
    """``emb[tok]`` for a DTensor table, on each rank's local tokens.
    Where the rank's tokens are fewer than its vocab shard's rows (a
    decode step), each rank looks up the tokens its rows hold (0
    elsewhere) and the shards' partial sums add up over the vocab's
    mesh dims; else the table is gathered whole (FSDP's all-gather) and
    looked up locally, its gradient a partial sum over the mesh dims
    that split the tokens.  DTensor's own strategies for the lookup
    fail: the index's backward (an accumulating ``index_put``) on torch
    2.11, ``F.embedding``'s masked partial on 2.13."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, p_tok = emb.device_mesh, list(tok.placements)
    split = [j for j, p in enumerate(emb.placements) if p == Shard(0)]
    coord, shard, n = mesh.get_coordinate(), 0, 1
    for j in split:         # this rank's slice of the vocabulary, in order
        shard, n = shard * mesh.size(j) + coord[j], n * mesh.size(j)
    rows = emb.shape[0] // n
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in p_tok]
    if not split or tok.to_local().numel() >= rows:
        return local_map(lambda e, t: e[t], out_placements=p_tok,
                         in_placements=([Replicate()] * mesh.ndim, p_tok),
                         in_grad_placements=(grad, p_tok),
                         device_mesh=mesh, redistribute_inputs=True)(emb,
                                                                     tok)

    def pick(e, t):
        at = t - shard * rows
        mine = (at >= 0) & (at < rows)
        got = e[torch.clamp(at, 0, rows - 1)]
        return torch.where(mine[..., None], got, torch.zeros_like(got))

    p_emb = [Shard(0) if j in split else Replicate()
             for j in range(mesh.ndim)]
    p_out = [Partial() if j in split else p for j, p in enumerate(p_tok)]
    g_emb = [Shard(0) if j in split else g for j, g in enumerate(grad)]
    return local_map(pick, out_placements=p_out,
                     in_placements=(p_emb, p_tok),
                     in_grad_placements=(g_emb, p_tok), device_mesh=mesh,
                     redistribute_inputs=True)(emb, tok)


def positions(cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    if batch.get("pos") is not None:
        return batch["pos"]
    B, S = batch["tokens"].shape
    # (B, S): ``attention_apply`` broadcasts it to M-RoPE's three streams
    pos = torch.arange(S, dtype=torch.int32,
                       device=batch["tokens"].device)[None].expand(B, S)
    # a DTensor under a mesh, so that RoPE's backward mixes no plain tensor
    return placed_as(pos, batch["tokens"])


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    head = params["emb"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.t())


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            mode: str, caches=None, ctx=None,
            last_token_only: bool = False):
    """Returns (logits, caches, aux): ``aux`` is the float32 sum of the
    blocks' auxiliary losses (the MoE balance loss), as the reference's
    third value."""
    with scope(ctx):
        x = embed(cfg, params, batch)
        x = constrain(x, ("batch", None, None), ctx)
        x, caches, aux = apply_blocks(cfg, params, x, mode=mode,
                                      pos=positions(cfg, batch),
                                      caches=caches, ctx=ctx)
        if last_token_only:
            # prefill only needs next-token logits: skip the (B,S,V)
            # unembed
            x = x[:, -1:]
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = constrain(unembed(cfg, params, x),
                           ("batch", None, "vocab"), ctx)
    return logits, caches, aux


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Any], *, ctx=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"ce", "aux"}): the float32 logsumexp cross-entropy of
    ``labels`` (mean, or over ``loss_mask``), plus the MoE balance loss."""
    with scope(ctx):
        logits, _, aux = forward(cfg, params, batch, mode="train", ctx=ctx)
        logits = logits.to(torch.float32)
        nll = logsumexp(logits) - label_logits(logits, batch["labels"])
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask.to(torch.float32)
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                     min=1.0)
        else:
            ce = torch.mean(nll)
        return ce + aux, {"ce": ce, "aux": aux}


def logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim.  On DTensor logits it is
    written out as ``jax.nn.logsumexp`` takes it, the max (no gradient
    through it), then the log of the sum of exp, each reduction a
    partial one over the vocab's mesh dims: DTensor's ``logsumexp``
    gathers the whole vocabulary first (the float32 logits whole on
    every rank)."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = _reduced(torch.amax(logits, dim=-1, keepdim=True)).detach()
    return torch.log(_reduced(torch.sum(torch.exp(logits - m), dim=-1))) \
        + m[..., 0]


def _reduced(x):
    """DTensor ``x`` with its partial reductions done (all-reduced to
    ``Replicate``), the other placements kept: the loss's (B, S) terms
    keep the batch placement, so their gradients reach the logits at
    the logits' own placements (DTensor could reduce-scatter them over
    the batch instead, and then re-shard the logits' gradient).  Any
    other ``x`` as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``, (B, S).  On DTensor logits it runs on
    each rank's local shards, as a vocab-parallel cross entropy does: a
    vocab shard gives the logits of the labels it holds and 0 elsewhere,
    the shards' sum is a partial sum over the vocab's mesh dims, and the
    backward scatters into the local shard alone.  DTensor's own
    ``gather`` would differentiate into a zero tensor of the logits'
    global shape on every rank (637 GB in float32 for train_4k's logits
    on the production mesh)."""
    idx = labels.long()[..., None]
    if not is_dtensor(logits):
        return torch.gather(logits, -1, idx)[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, pl, vocab = logits.device_mesh, list(logits.placements), \
        Shard(logits.ndim - 1)
    coord, shard = mesh.get_coordinate(), 0
    for j, p in enumerate(pl):
        if p == vocab:      # this rank's slice of the vocabulary, in order
            shard = shard * mesh.size(j) + coord[j]
    p_idx = [Replicate() if p == vocab else p for p in pl]
    p_out = [Partial() if p == vocab else p for p in pl]

    def pick(lg, ix):
        n = lg.shape[-1]
        at = ix - shard * n
        mine = (at >= 0) & (at < n)
        got = torch.gather(lg, -1, torch.clamp(at, 0, n - 1))
        return torch.where(mine, got, torch.zeros_like(got))[..., 0]

    return _reduced(local_map(pick, out_placements=p_out,
                              in_placements=(pl, p_idx), device_mesh=mesh,
                              redistribute_inputs=True)(logits, idx))


def value_and_grad(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   ctx=None):
    """((loss, parts), grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives), in the leaves' dtypes and, under a
    ``ctx``, their placements."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, tree_unflatten(spec, leaves), batch,
                              ctx=ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else as_placed(g, p)
             for p, g in zip(leaves, grads)]
    parts = {k: v.detach() for k, v in parts.items()}
    return (loss.detach(), parts), tree_unflatten(spec, grads)


def make_train_step(cfg: ModelConfig, optimizer, *, clip_norm: float = 1.0,
                    ctx=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``state`` = {"params", "opt", "step"}; ``optimizer`` is a
    ``repro_torch.optim.adamw.AdamW``.  The global grad norm is taken in
    float32, the grads clipped to ``clip_norm`` and cast back to their
    dtype before the update; the input state is left as it was.  Under a
    ``ctx`` the state and batch are DTensors, the norm sums every
    shard's squares over the mesh, and the metrics are plain tensors."""

    def train_step(state, batch):
        (loss, parts), grads = value_and_grad(cfg, state["params"], batch,
                                              ctx=ctx)
        g_leaves, spec = tree_flatten(grads)
        gnorm = torch.sqrt(sum(
            full(torch.sum(torch.square(g.to(torch.float32))))
            for g in g_leaves))
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_unflatten(spec, [
            (g.to(torch.float32) * scale).to(g.dtype) for g in g_leaves])
        del g_leaves
        with scope(ctx):
            params, opt = optimizer.update(state["params"], grads,
                                           state["opt"], state["step"])
        metrics = {"loss": full(loss), "ce": full(parts["ce"]),
                   "aux": full(parts["aux"]), "grad_norm": gnorm}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, ctx=None):
    """prefill(params, batch, caches0) -> (caches, last_token_logits);
    ``caches0`` is filled in place."""

    @torch.no_grad()
    def prefill(params, batch, caches0):
        logits, caches, _ = forward(cfg, params, batch, mode="prefill",
                                    caches=caches0, ctx=ctx,
                                    last_token_only=True)
        return caches, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig, *, ctx=None):
    """decode(params, batch, caches) -> (caches, logits (B,V));
    ``caches`` are updated in place."""

    @torch.no_grad()
    def decode(params, batch, caches):
        logits, caches, _ = forward(cfg, params, batch, mode="decode",
                                    caches=caches, ctx=ctx)
        return caches, logits[:, -1]

    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
