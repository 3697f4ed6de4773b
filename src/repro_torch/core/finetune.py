"""Dedup-aware fine-tuning (paper Sec. 4.3 "Fine-Tuning").

After deduplication, shared blocks are frozen and only blocks private to
one model are tuned.  We realize the freeze as a *gradient mask* over the
block grid: 1 where a block is private to the model, 0 where shared.
Works with any JAX optimizer (mask multiplies the gradient pytree).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .dedup import Deduplicator


def private_block_mask(dedup: Deduplicator, model: str,
                       tensor: str) -> np.ndarray:
    """[num_blocks] float mask: 1.0 for blocks only this model references."""
    e = dedup.models[model].tensors[tensor]
    mask = np.zeros(e.grid.num_blocks, dtype=np.float32)
    for bid, did in enumerate(e.block_map):
        owners = dedup.owners[int(did)]
        models = {m for (m, _t) in owners}
        mask[bid] = 1.0 if models == {model} else 0.0
    return mask


def gradient_mask(dedup: Deduplicator, model: str,
                  tensor: str) -> np.ndarray:
    """Full-tensor-shape gradient mask (blocks expanded, padding cropped)."""
    e = dedup.models[model].tensors[tensor]
    bm = private_block_mask(dedup, model, tensor)
    bh, bw = e.grid.block_shape
    blocks = np.repeat(np.repeat(bm[:, None, None], bh, 1), bw, 2)
    from .blocks import unblock_tensor
    return unblock_tensor(blocks, e.grid)


def gradient_masks(dedup: Deduplicator, model: str) -> Dict[str, np.ndarray]:
    return {t: gradient_mask(dedup, model, t)
            for t in dedup.models[model].tensors}


def apply_masks(grads: Dict[str, np.ndarray],
                masks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: g * masks[k] if k in masks else g for k, g in grads.items()}
