"""gemma2-9b [dense]: local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    kv_heads=8,
    d_ff=14336,
    vocab=256_000,
    head_dim=256,             # gemma2 uses wide heads (16*256 != d_model)
    rope_theta=10_000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    window_pattern=2,         # alternate local / global
    tie_embeddings=True,
    embed_scale=True,         # embeddings scaled by sqrt(d_model)
    act="gelu",               # GeGLU
    gated_mlp=True,
    source="arXiv:2408.00118",
)
