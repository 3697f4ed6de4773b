"""qwen3-14b [dense]: qk_norm + GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    kv_heads=8,
    d_ff=17408,
    vocab=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    act="silu",
    gated_mlp=True,
    source="hf:Qwen/Qwen3-8B",
)
