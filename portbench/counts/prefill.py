"""Model operations of one prefill query (rows x tokens, last-position
logits), counted from the configuration by its architecture module
(``archs/``) out of the pieces here: every matrix product of the layers,
attention over the visible pairs, the Mamba-2 scan's state update and
output (4 * head_dim * state per token and head) and its causal
convolution, and the head on the last position.  Elementwise work,
norms and the embedding lookup count nothing."""
from __future__ import annotations

from typing import Dict

from portbench import archs
from portbench.counts.flash_attention import visible_pairs


def flops(cfg: Dict, rows: int, tokens: int) -> float:
    return archs.of(cfg).prefill_flops(cfg, rows, tokens)


def attention(rows: int, tokens: int, d: int, H: int, K: int, hd: int,
              window: int) -> float:
    """q, k, v and wo, and the scores and values over the visible pairs."""
    T = rows * tokens
    return (2.0 * T * d * (H * hd + 2 * K * hd) + 2.0 * T * H * hd * d
            + 4.0 * hd * H * rows * visible_pairs(tokens, window))


def mlp(T: int, d: int, f: int) -> float:
    """The gated feed-forward's w1, w3 and w2 over T tokens."""
    return 2.0 * T * 3 * d * f


def mixer(T: int, d: int, din: int, nh: int, gn: int, conv: int,
          hp: int, N: int) -> float:
    """Mamba-2's in_proj, out_proj, convolution and scan over T tokens."""
    return (2.0 * T * d * (2 * din + 2 * gn + nh) + 2.0 * T * din * d
            + 2.0 * T * conv * (din + 2 * gn) + 4.0 * T * nh * hp * N)


def head(rows: int, d: int, V: int) -> float:
    return 2.0 * rows * d * V
