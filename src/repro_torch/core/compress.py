"""Composition with pruning and quantization (paper Sec. 7.6.2, Tab. 9).

Dedup is a *cross-model* compression; pruning/quantization are per-model.
The paper observes they compose because pruning/quantizing does not
significantly change cross-model block similarity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def magnitude_prune(x: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero the smallest-|w| fraction (Han et al. '15 iterative pruning)."""
    flat = np.abs(x).ravel()
    k = int(len(flat) * sparsity)
    if k == 0:
        return np.array(x, copy=True)
    thresh = np.partition(flat, k - 1)[k - 1]
    out = np.array(x, copy=True)
    out[np.abs(out) <= thresh] = 0.0
    return out


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Symmetric per-tensor int8 quantization; returns (q, scale)."""
    scale = float(np.max(np.abs(x))) / 127.0 or 1.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * scale


def quantize_model(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Quantize+dequantize: values snap to the int8 lattice so that exact
    and LSH dedup both see increased block collisions (Tab. 9 'dedup+quant')."""
    out = {}
    for k, v in tensors.items():
        q, s = quantize_int8(v)
        out[k] = dequantize_int8(q, s)
    return out


def prune_model(tensors: Dict[str, np.ndarray],
                sparsity: float) -> Dict[str, np.ndarray]:
    return {k: magnitude_prune(v, sparsity) for k, v in tensors.items()}


def nbytes_sparse(x: np.ndarray, itemsize: int = 4) -> int:
    """CSR-style cost model for a pruned tensor (values + column idx)."""
    nnz = int(np.count_nonzero(x))
    return nnz * (itemsize + 4) + x.shape[0] * 8 if x.ndim >= 1 else nnz * itemsize
