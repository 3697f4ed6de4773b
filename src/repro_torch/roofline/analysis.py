"""Roofline terms of a dry-run cell, on an NVIDIA H100.

Counterpart of ``repro.roofline.analysis``, with its formulas and keys
and a Hopper hardware model: the H100 SXM5 80GB datasheet values
(NVIDIA H100 Tensor Core GPU datasheet, SXM5 column):

  989 TFLOP/s dense bf16 tensor-core peak (1,979 with 2:4 sparsity);
  3.35 TB/s HBM3;
  NVLink 4: 900 GB/s per GPU in total, 450 GB/s in each direction.

The trace (``roofline.trace``) counts one rank's share of the step, so
its FLOPs and bytes and the collective bytes are per device, and each
term is seconds a step on one card:

  compute    = flops / peak_flops
  memory     = bytes_accessed / hbm_bw
  collective = collective_bytes / nvlink_bw

``collective_bytes`` sums the *result* buffer of every collective of
the trace; all-reduce counts twice (the reduce-scatter and all-gather
phases of a ring).  This is a bandwidth-optimal-ring lower bound over
NVLink alone: latency, and the slower network between hosts that a
mesh of more than 8 cards crosses, are not modelled.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

HW = {
    "peak_flops": 989e12,        # dense bf16, H100 SXM5 datasheet
    "hbm_bw": 3.35e12,           # bytes/s, HBM3, H100 SXM5 datasheet
    "nvlink_bw": 450e9,          # bytes/s per direction, NVLink 4
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")


def collective_bytes(events: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Per-kind result bytes of a trace's collectives (``(kind, bytes)``
    events of ``roofline.trace.StepTrace``), with the reference's keys:
    one per kind, ``count``, ``total`` and ``weighted_total`` (all-reduce
    counted twice)."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in events:
        if kind not in _COLLECTIVES:
            raise ValueError(f"collective_bytes: unknown kind {kind!r}")
        out[kind] += float(nbytes)
        out["count"] += 1
    out["total"] = sum(v for k, v in out.items() if k in _COLLECTIVES)
    # all-reduce moves ~2x its buffer over the wire (RS + AG ring phases)
    out["weighted_total"] = out["total"] + out["all-reduce"]
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float) -> Dict[str, float]:
    terms = {
        "compute_s": flops / HW["peak_flops"],
        "memory_s": bytes_accessed / HW["hbm_bw"],
        "collective_s": collective_bytes / HW["nvlink_bw"],
    }
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = (terms["compute_s"] / bound) if bound else 0.0
    return terms


def summarize_cell(record: Dict, model_flops: Optional[float] = None) -> Dict:
    """record: one dry-run JSON dict -> roofline summary row."""
    cost = record.get("cost_analysis", {})
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    coll = record.get("collectives", {})
    terms = roofline_terms(flops, bytes_accessed,
                           float(coll.get("weighted_total", 0.0)))
    out = dict(record.get("meta", {}))
    out.update(terms)
    out["flops"] = flops
    out["bytes_accessed"] = bytes_accessed
    out["collective_bytes"] = coll.get("weighted_total", 0.0)
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / flops if flops else 0.0
    return out
