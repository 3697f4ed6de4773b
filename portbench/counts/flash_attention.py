"""``flash_attention`` calls of one prefill query, and each call's bound.

Operations: q.k and p.v over the visible (query, key) pairs, 2 * hd
each, per query head.  Bytes: q, k and v read once and the output
written once, all at the configuration's 2-byte bfloat16 (the least a
call at that precision moves; the program now writes its output in
float32, so the share reads a little low, never high).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench import archs

BYTES = 2


def visible_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs of an S-token prompt; with a window W a
    query sees at most the W latest keys, itself included."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def calls(cfg: Dict, rows: int, tokens: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each attention layer's call, in layer
    order (the architecture's ``attention_layers``)."""
    out = []
    for w, H, K, hd in archs.of(cfg).attention_layers(cfg):
        flops = 4.0 * hd * H * rows * visible_pairs(tokens, w)
        nbytes = float(BYTES * rows * tokens * hd * (2 * H + 2 * K))
        out.append((flops, nbytes))
    return out


def bound_seconds(flops: float, nbytes: float, peaks: Dict) -> float:
    return max(flops / peaks["bf16_flop_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
