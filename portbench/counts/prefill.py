"""Model operations of one prefill query (rows x tokens, last-position
logits), counted from the configuration: every matrix product of the
layers, attention over the visible pairs, the Mamba-2 scan's state update
and output (4 * head_dim * state per token and head) and its causal
convolution, and the head on the last position.  Elementwise work,
norms and the embedding lookup count nothing."""
from __future__ import annotations

from typing import Dict

from portbench import weights
from portbench.counts.flash_attention import visible_pairs


def flops(cfg: Dict, rows: int, tokens: int) -> float:
    z = weights.dims(cfg)
    d, H, K, hd, f, V = (z[k] for k in ("d", "H", "K", "hd", "f", "V"))
    T = rows * tokens
    total = 0.0
    for w in weights.windows(cfg):
        total += 2.0 * T * d * (H * hd + 2 * K * hd)          # q, k, v
        total += 2.0 * T * H * hd * d                         # wo
        total += 4.0 * hd * H * rows * visible_pairs(tokens, w)
        total += 2.0 * T * 3 * d * f                          # w1, w3, w2
        if cfg["architecture"] == "hybrid":
            din, nh, gn = z["din"], z["nh"], z["gn"]
            total += 2.0 * T * d * (2 * din + 2 * gn + nh)    # in_proj
            total += 2.0 * T * din * d                        # out_proj
            total += 2.0 * T * z["conv"] * z["conv_ch"]       # conv
            total += 4.0 * T * nh * z["mhd"] * z["N"]         # scan
    return total + 2.0 * rows * d * V                         # head
