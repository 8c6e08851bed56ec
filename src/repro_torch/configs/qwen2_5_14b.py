"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    d_ff=13824,
    vocab=152064,
    attention=AttentionCfg(n_heads=40, n_kv_heads=8, d_head=128,
                           qkv_bias=True, rope_theta=1e6),
    tie_embeddings=False,
)
