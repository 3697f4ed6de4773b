"""deepseek-7b [dense]: llama-architecture.  [arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    kv_heads=32,              # MHA
    d_ff=11008,
    vocab=102_400,
    head_dim=128,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    source="arXiv:2401.02954",
)
