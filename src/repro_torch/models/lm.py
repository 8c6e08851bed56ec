"""LM-level glue: embedding, forward, and the prefill/decode step builders.

``batch`` dicts use the reference's keys:
  prefill: {"tokens": (B,S) int32, "pos": (B,S) or (B,S,3) int32
            (optional), "vision_embeds": (B,S,D), "vision_mask": (B,S)
            bool (the vision stub, optional)}
  decode:  {"tokens": (B,1) int32, "pos": (B,1) or (B,1,3) int32}

(B, S, 3) positions are M-RoPE's (t, h, w) streams; ``attention_apply``
broadcasts (B, S) ones to all three (text tokens).  The vision stub
(qwen2-vl) takes precomputed patch embeddings in place of the token
embeddings where ``vision_mask`` is set; the audio stub (musicgen) has
no model code: the backbone reads codec token ids as any vocabulary.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import apply_blocks


def embed(cfg: ModelConfig, params, batch: Dict[str, Any]) -> torch.Tensor:
    x = params["emb"][batch["tokens"].long()]
    if cfg.vision_stub and batch.get("vision_embeds") is not None:
        x = torch.where(batch["vision_mask"][..., None],
                        batch["vision_embeds"].to(x.dtype), x)
    return x


def positions(cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    if batch.get("pos") is not None:
        return batch["pos"]
    B, S = batch["tokens"].shape
    # (B, S): ``attention_apply`` broadcasts it to M-RoPE's three streams
    return torch.arange(S, dtype=torch.int32,
                        device=batch["tokens"].device)[None].expand(B, S)


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    head = params["emb"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head.t())


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            mode: str, caches=None, last_token_only: bool = False):
    """Returns (logits, caches, aux): ``aux`` is the float32 sum of the
    blocks' auxiliary losses (the MoE balance loss), as the reference's
    third value."""
    x = embed(cfg, params, batch)
    x, caches, aux = apply_blocks(cfg, params, x, mode=mode,
                                  pos=positions(cfg, batch), caches=caches)
    if last_token_only:
        # prefill only needs next-token logits: skip the (B,S,V) unembed
        x = x[:, -1:]
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x), caches, aux


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, batch, caches0) -> (caches, last_token_logits);
    ``caches0`` is filled in place."""

    @torch.no_grad()
    def prefill(params, batch, caches0):
        logits, caches, _ = forward(cfg, params, batch, mode="prefill",
                                    caches=caches0, last_token_only=True)
        return caches, logits[:, -1]

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, batch, caches) -> (caches, logits (B,V));
    ``caches`` are updated in place."""

    @torch.no_grad()
    def decode(params, batch, caches):
        logits, caches, _ = forward(cfg, params, batch, mode="decode",
                                    caches=caches)
        return caches, logits[:, -1]

    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
