"""arctic-480b [moe]: 128 experts top-2 with a parallel dense-FFN residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Cross-*expert* block dedup makes this the paper technique's best fit
(128 experts ~ 128 model variants, DESIGN.md §5).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    kv_heads=8,
    d_ff=4864,
    vocab=32_000,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25,
                  dense_ff=4864),
    act="silu",
    gated_mlp=True,
    optimizer="adafactor",    # fp32 Adam states for 480B do not fit 256 chips
    source="hf:Snowflake/snowflake-arctic-base",
)
