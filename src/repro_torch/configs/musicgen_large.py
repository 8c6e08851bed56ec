"""musicgen-large [audio]: 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048. Decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: the backbone consumes codec token ids
directly (the codebook-interleaving delay pattern lives in the frontend).
MHA (kv == heads); learned-sinusoidal positions approximated with RoPE
backbone-side (documented deviation; attention compute is identical).
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab=2048,
    attention=AttentionCfg(n_heads=32, n_kv_heads=32, d_head=64,
                           rope_theta=1e4),
    tie_embeddings=False,
    audio_stub=True,
    act="gelu",
)
