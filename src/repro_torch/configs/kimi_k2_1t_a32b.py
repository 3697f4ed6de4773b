"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8, first
layer dense.  [arXiv:2501.kimi2; unverified — paper-table config]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    kv_heads=8,
    d_ff=18432,               # dense first layer FFN width
    vocab=163_840,
    head_dim=112,             # 7168 / 64
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048, capacity_factor=1.25),
    first_dense_layers=1,
    act="silu",
    gated_mlp=True,
    optimizer="adafactor",
    source="arXiv:2501.kimi2",
)
