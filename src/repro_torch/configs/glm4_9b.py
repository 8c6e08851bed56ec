"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE, GQA. [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab=151552,
    attention=AttentionCfg(n_heads=32, n_kv_heads=2, d_head=128,
                           qkv_bias=True, rope_theta=1e6),
    tie_embeddings=False,
)
