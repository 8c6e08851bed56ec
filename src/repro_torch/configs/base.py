"""Model/run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; reduced smoke
variants are derived with ``reduce_for_smoke``. Configs are frozen dataclasses
so they are hashable and usable as jit static arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttentionCfg:
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # None = global causal attention
    mrope_sections: Optional[Tuple[int, ...]] = None  # M-RoPE (qwen2-vl)
    softmax_scale: Optional[float] = None  # default 1/sqrt(d_head)
    logit_cap: Optional[float] = None      # tanh soft-cap (grok/gemma style)


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # number of always-on shared experts
    d_shared: int = 0             # total hidden size of the fused shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclass(frozen=True)
class RWKVCfg:
    head_size: int = 64
    decay_lora: int = 64          # low-rank dim for data-dependent decay
    mix_lora: int = 32            # low-rank dim for ddlerp token-shift


@dataclass(frozen=True)
class RGLRUCfg:
    width: int = 0                # recurrence width (0 => d_model)
    conv_width: int = 4
    c: float = 8.0                # RG-LRU gate exponent scale


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...] = ("attn",)   # e.g. ("rec","rec","attn")
    attention: Optional[AttentionCfg] = None
    moe: Optional[MoECfg] = None
    rwkv: Optional[RWKVCfg] = None
    rglru: Optional[RGLRUCfg] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu | relu2 (rwkv channel-mix)
    dtype: str = "bfloat16"
    vision_stub: bool = False     # qwen2-vl: inject precomputed patch embeddings
    audio_stub: bool = False      # musicgen: EnCodec-token frontend stub
    # attention compute policy
    attn_chunk: int = 1024        # KV-chunk for online-softmax attention
    use_pallas: bool = False      # kept so configs match the reference; unread
    remat: str = "block"          # none | block (checkpoint each block)
    remat_span: int = 1           # layer-groups per remat unit (activation-
    #                               memory vs recompute-granularity knob)
    moe_dispatch: str = "global"  # global (baseline) | grouped (row-local)
    kv_dtype: str = ""            # "" => model dtype; "int8" => quantized KV
    # decode/state
    max_decode_len: int = 0       # filled per shape at lowering time

    @property
    def n_params(self) -> int:
        """Analytical parameter count (embedding included once if tied)."""
        return count_params(self)

    @property
    def n_active_params(self) -> int:
        return count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attention
    d = cfg.d_model
    qkv = d * (a.n_heads + 2 * a.n_kv_heads) * a.d_head
    if a.qkv_bias:
        qkv += (a.n_heads + 2 * a.n_kv_heads) * a.d_head
    out = a.n_heads * a.d_head * d
    return qkv + out


def _ffn_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    if cfg.moe is None:
        return 3 * d * cfg.d_ff  # gated (w1, w3, w2)
    m = cfg.moe
    routed_each = 3 * d * m.d_expert
    n = m.top_k if active_only else m.n_experts
    total = n * routed_each + d * m.n_experts  # + router
    if m.d_shared:
        total += 3 * d * m.d_shared + d  # shared expert + its gate
    return total


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    r = cfg.rwkv
    tm = 5 * d * d + 2 * d * r.decay_lora + 10 * d * r.mix_lora + 10 * d
    cm = 2 * d * cfg.d_ff + d * d + 2 * d  # key, value, receptance gate
    return tm + cm


def _rglru_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    w = cfg.rglru.width or d
    # in-proj (x, gate), conv1d, input/rec gates, out-proj, Lambda
    return 2 * d * w + cfg.rglru.conv_width * w + 2 * w * w + w * d + 2 * w


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = 0
    for i in range(cfg.n_layers):
        kind = cfg.block_pattern[i % len(cfg.block_pattern)]
        if kind == "attn":
            total += _attn_params(cfg) + _ffn_params(cfg, active_only)
            total += 2 * cfg.d_model  # norms
        elif kind == "rwkv":
            total += _rwkv_params(cfg) + 2 * cfg.d_model
        elif kind == "rec":
            total += _rglru_params(cfg) + _ffn_params(cfg, active_only)
            total += 2 * cfg.d_model
        else:
            raise ValueError(kind)
    total += cfg.vocab * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model
    total += cfg.d_model  # final norm
    return total


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    pat = cfg.block_pattern
    n_layers = max(len(pat), 2 * len(pat))
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        d_ff=128,
        vocab=256,
        attn_chunk=32,
        remat="none",
    )
    if cfg.attention is not None:
        changes["attention"] = dataclasses.replace(
            cfg.attention,
            n_heads=4,
            n_kv_heads=max(1, min(cfg.attention.n_kv_heads, 2)),
            d_head=16,
            window=min(cfg.attention.window, 32) if cfg.attention.window else None,
        )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=2,
            d_expert=32,
            d_shared=64 if cfg.moe.d_shared else 0,
        )
    if cfg.rwkv is not None:
        changes["rwkv"] = dataclasses.replace(cfg.rwkv, head_size=16,
                                              decay_lora=8, mix_lora=8)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, width=64)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """long_500k only runs for sub-quadratic (SSM/hybrid/linear-attn) archs."""
    if shape.name == "long_500k":
        subquad = all(b != "attn" for b in cfg.block_pattern) or (
            cfg.attention is not None and cfg.attention.window is not None
        )
        if not subquad:
            return False, ("pure full-attention arch: 524k-token decode requires "
                           "sub-quadratic attention (skip noted in DESIGN.md §7)")
    return True, ""
