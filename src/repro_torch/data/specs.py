"""Concrete batches for the dry-run's input specs.

Counterpart of ``make_batch_from_specs`` in ``repro.data.pipeline``
(``data/pipeline.py`` here is the trimmed copy without it): the same
numpy draws from the same seed, leaf by leaf in ``jax.tree_util``'s
order, then converted to torch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..tree import tree_map


def make_batch_from_specs(specs, *, seed: int = 0, device=None) -> Dict:
    """Concrete batch matching an ``input_specs`` tree (smoke tests):
    integers in [0, 64), floats standard normal, each rounded once from
    numpy's float64 to the leaf's dtype through float32 (as
    ``ml_dtypes``' bfloat16 cast rounds)."""
    rng = np.random.default_rng(seed)

    def gen(t):
        shape = tuple(t.shape)
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            arr = rng.integers(0, 64, shape)
            return torch.from_numpy(arr).to(device=device, dtype=t.dtype)
        arr = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=t.dtype)

    return tree_map(gen, specs)
