"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision tower is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (B,S,D) plus an injection mask; the backbone applies M-RoPE with
(t,h,w) position streams (sections 16/24/24 of the 64 rotary pairs).
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab=152064,
    attention=AttentionCfg(n_heads=28, n_kv_heads=4, d_head=128,
                           qkv_bias=True, rope_theta=1e6,
                           mrope_sections=(16, 24, 24)),
    tie_embeddings=False,
    vision_stub=True,
)
