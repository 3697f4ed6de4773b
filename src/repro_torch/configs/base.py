"""Architecture + shape configuration system.

Every assigned architecture gets a ``ModelConfig`` in its own module; the
four assigned input shapes are global (``SHAPES``).  ``reduced()`` derives
the CPU-smoke-test config for an architecture (same family, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    dense_ff: int = 0              # arctic: parallel dense-FFN residual width


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 0        # gemma2 local layers / hymba
    window_pattern: int = 0        # every Nth layer global (gemma2: 2)
    tie_embeddings: bool = False
    norm_type: str = "rms"         # rms | layer
    norm_eps: float = 1e-6
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU / plain)
    gated_mlp: bool = True
    embed_scale: bool = False      # gemma2 multiplies embeddings by sqrt(d)
    moe: Optional[MoEConfig] = None
    first_dense_layers: int = 0    # kimi-k2: layer 0 dense
    ssm: Optional[SSMConfig] = None
    hybrid: bool = False           # hymba: parallel attn + SSM heads
    encdec: bool = False           # whisper
    enc_layers: int = 0
    vlm_stub: bool = False         # phi-3-vision: precomputed patch embeddings
    num_patches: int = 576
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: bool = False      # dry-run accounting: unroll layer scans so
                                   # cost_analysis counts every layer (XLA
                                   # counts while-loop bodies once)
    optimizer: str = "adamw"       # adamw | adafactor (giant MoEs)
    # --- dedup-serving knobs (the paper's technique as a runtime feature) ---
    dedup_serving: bool = False    # lower serve with virtual (paged) weights
    dedup_ratio: float = 0.35      # distinct-block fraction (paper: 2.7-3.6x)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid(sliding-window+SSM) only.
        gemma2's alternating pattern still has full-attention global layers
        -> quadratic -> skipped (DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all ten assigned archs decode (whisper is enc-dec)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers), for 6ND."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.hd
        attn = d * self.num_heads * hd + 2 * d * self.kv_heads * hd \
            + self.num_heads * hd * d
        mlp_mult = 3 if self.gated_mlp else 2
        if self.family == "ssm":
            s = self.ssm
            din = s.expand * d
            nheads = din // s.head_dim
            per_layer = d * (2 * din + 2 * s.n_groups * s.d_state + nheads) \
                + din * d + nheads + nheads
        elif self.family == "hybrid":
            s = self.ssm
            din = s.expand * d
            nheads = din // s.head_dim
            ssm_p = d * (2 * din + 2 * s.n_groups * s.d_state + nheads) + din * d
            per_layer = attn + ssm_p + mlp_mult * d * self.d_ff
        elif self.moe is not None:
            moe_layers = self.num_layers - self.first_dense_layers
            dense_layers = self.first_dense_layers
            expert = mlp_mult * d * self.moe.d_ff
            per = attn + self.moe.num_experts * expert \
                + (mlp_mult * d * self.moe.dense_ff if self.moe.dense_ff else 0) \
                + d * self.moe.num_experts  # router
            dense = attn + mlp_mult * d * self.d_ff if self.d_ff else attn
            return emb + per * moe_layers + dense * dense_layers
        else:
            per_layer = attn + mlp_mult * d * self.d_ff
        total = emb + per_layer * self.num_layers
        if self.encdec:
            # encoder layers: attn + ungated mlp; decoder adds cross-attn
            total += self.enc_layers * (attn + 2 * d * self.d_ff)
            total += self.num_layers * attn     # cross attention
        return total

    def active_param_count(self) -> int:
        """MoE: only top_k experts are active per token (6·N_active·D)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        expert = mlp_mult * d * self.moe.d_ff
        inactive = (self.moe.num_experts - self.moe.top_k) * expert
        return self.param_count() - inactive * (self.num_layers
                                                - self.first_dense_layers)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-not) per the assignment's skip rules."""
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k decode is O(L^2); "
                       "skipped per assignment (see DESIGN.md §5)")
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, cfg.first_dense_layers + 1),
        d_model=64, num_heads=4, kv_heads=2, d_ff=128, vocab=256,
        head_dim=16, dtype="float32", remat=False,
        enc_layers=2 if cfg.encdec else 0,
        num_patches=8 if cfg.vlm_stub else cfg.num_patches,
        sliding_window=16 if cfg.sliding_window else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                              d_ff=64, capacity_factor=2.0,
                              dense_ff=32 if cfg.moe.dense_ff else 0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=8)
    return dataclasses.replace(cfg, **kw)
