"""hymba-1.5b [hybrid]: parallel attention + mamba heads in every layer.
[arXiv:2411.13676; hf]

Hymba runs sliding-window attention in all but three layers (first,
middle, last are global) with an SSM branch in parallel; outputs are
mean-fused.  ssm_state=16 per assignment.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    rope_theta=10_000.0,
    sliding_window=1024,
    window_pattern=-3,        # sentinel: first/middle/last layers global
    hybrid=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    act="silu",
    gated_mlp=True,
    source="arXiv:2411.13676",
)
