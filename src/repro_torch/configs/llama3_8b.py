"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA, 128k vocab. [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=128256,
    attention=AttentionCfg(n_heads=32, n_kv_heads=8, d_head=128,
                           rope_theta=5e5),
    tie_embeddings=False,
)
