"""Gradient compression for the cross-pod (DCN) all-reduce.

Counterpart of ``repro.distributed.compression``: int8 quantization with
**error feedback** (residual carried to the next step), applied per leaf
with a per-leaf fp32 scale; quantize -> (all-reduce) -> dequantize cuts
the wire bytes 4x vs fp32 / 2x vs bf16, and error feedback keeps the
optimizer trajectory unbiased to first order (Karimireddy et al. '19).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payload is the reference's bit for bit.

``make_grad_compressor`` returns a transform of ``(grads, err)``; the
error state starts from ``init_error_state``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import tree_map

F32 = torch.float32


def quantize_leaf(g, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q, scale.to(F32)


def dequantize_leaf(q, scale) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(grads, err_state, bits: int = 8):
    """(grads, err) -> (decompressed grads, new err).  The round trip
    models the compressed wire format."""
    def leaf(g, e):
        g = g.to(F32) + e
        q, s = quantize_leaf(g, bits)
        deq = dequantize_leaf(q, s)
        return deq, g - deq
    out = tree_map(leaf, grads, err_state)
    is_pair = lambda x: isinstance(x, tuple)            # noqa: E731
    deq = tree_map(lambda o: o[0], out, is_leaf=is_pair)
    err = tree_map(lambda o: o[1], out, is_leaf=is_pair)
    return deq, err


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def make_grad_compressor(bits: int = 8):
    """A transform of ``(grads, err)``; the caller carries the error
    state from step to step (see ``launch/train.py``)."""
    def transform(grads_and_err):
        grads, err = grads_and_err
        return compress_with_feedback(grads, err, bits)
    return transform
