"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 experts top-4, 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 4 shared experts are fused into one d_shared=5632 gated FFN (their hidden
sizes concatenate; mathematically identical for gated-MLP experts).
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    d_ff=1408,
    vocab=151936,
    attention=AttentionCfg(n_heads=16, n_kv_heads=16, d_head=128,
                           qkv_bias=True, rope_theta=1e6),
    moe=MoECfg(n_experts=60, top_k=4, d_expert=1408,
               n_shared=4, d_shared=5632),
    tie_embeddings=True,
)
