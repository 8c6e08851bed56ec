"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.

Finch: data-dependent decay. [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import ModelConfig, RWKVCfg

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv=RWKVCfg(head_size=64, decay_lora=64, mix_lora=32),
    attention=None,
    tie_embeddings=False,
    act="relu2",
)
