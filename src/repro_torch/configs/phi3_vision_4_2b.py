"""phi-3-vision-4.2b [vlm]: phi3-mini text backbone + CLIP frontend stub.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Per assignment, the vision frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings; the backbone consumes [text tokens | patch
embeddings] as one causal sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    kv_heads=32,              # MHA (GQA kv=32)
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    rope_theta=10_000.0,
    act="silu",
    gated_mlp=True,
    vlm_stub=True,
    num_patches=576,          # 24x24 CLIP-L patch grid
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
