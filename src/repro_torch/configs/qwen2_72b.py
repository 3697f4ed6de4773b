"""qwen2-72b [dense]: GQA with QKV bias.  [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=29568,
    vocab=152_064,
    head_dim=128,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    source="arXiv:2407.10671",
)
