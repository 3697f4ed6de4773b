"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,              # attention-free
    kv_heads=0,
    d_ff=0,                   # no MLP: pure mamba stack
    vocab=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
