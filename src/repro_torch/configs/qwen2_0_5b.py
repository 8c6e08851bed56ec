"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA with QKV bias. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    d_ff=4864,
    vocab=151936,
    attention=AttentionCfg(n_heads=14, n_kv_heads=2, d_head=64,
                           qkv_bias=True, rope_theta=1e6),
    tie_embeddings=True,
)
