"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

Attention logits are tanh-capped at 30 (grok-1 reference implementation).
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab=131072,
    attention=AttentionCfg(n_heads=48, n_kv_heads=8, d_head=128,
                           rope_theta=1e4, logit_cap=30.0),
    moe=MoECfg(n_experts=8, top_k=2, d_expert=32768),
    tie_embeddings=True,
)
