"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000. RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427; hf]

26 layers = 8 full (rec,rec,attn) groups + 2 tail rec layers.
Local attention window 2048; MQA (kv=1); gelu MLP.
"""
from repro_torch.configs.base import AttentionCfg, ModelConfig, RGLRUCfg

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rec", "rec", "attn"),
    attention=AttentionCfg(n_heads=10, n_kv_heads=1, d_head=256,
                           rope_theta=1e4, window=2048),
    rglru=RGLRUCfg(width=2560, conv_width=4, c=8.0),
    tie_embeddings=True,
    act="gelu",
)
