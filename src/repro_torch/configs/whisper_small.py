"""whisper-small [audio]: encoder-decoder transformer backbone.
[arXiv:2212.04356; unverified]

The conv/mel frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings for the encoder.  LayerNorm + plain GELU MLP
+ learned positions (no RoPE), faithful to the whisper backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,            # decoder layers
    enc_layers=12,
    d_model=768,
    num_heads=12,
    kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    head_dim=64,
    norm_type="layer",
    act="gelu",
    gated_mlp=False,
    encdec=True,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
