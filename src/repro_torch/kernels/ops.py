"""Wrappers of the dedup kernels (counterparts of ``repro.kernels.ops``).

A tensor on the CPU goes to the plain PyTorch version in :mod:`.ref`.  A
CUDA tensor launches the hand-written kernel from ``csrc/`` on the
current stream, or raises: when the library did not build, when a launch
fails, or when the inputs are not what the kernel takes.  There is no
fallback from a CUDA tensor to the plain version.

Each kernel keeps a launch count in :data:`LAUNCHES`, raised by one
exactly where the wrapper launches the kernel, so a run can show that its
hot path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build, ref

__all__ = ["LAUNCHES", "reset_launches", "dedup_matmul", "dedup_embedding",
           "dedup_embedding_striped", "ref"]

#: kernel name -> number of launches of its CUDA kernel in this process
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}

_MATMUL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_index(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: indices must be int32, got {t.dtype}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


# ------------------------------------------------------------ dedup_matmul --
def dedup_matmul(x, pool, block_map, out_dtype=None):
    """x [..., K] @ W_virtual -> [..., N].

    pool [n_distinct, bk, bn]; block_map [K/bk, N/bn] int32.  On CUDA the
    kernel masks a ragged M itself (no padding pass); x, pool and the
    output share one dtype (float32 or bfloat16)."""
    if x.device.type == "cpu":
        return ref.dedup_matmul(x, pool, block_map, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dedup_matmul: no kernel for {x.device}")
    nkb, nnb = block_map.shape
    _, bk, bn = pool.shape
    if x.shape[-1] != nkb * bk:
        raise ValueError(f"dedup_matmul: x has K={x.shape[-1]}, "
                         f"the block map covers {nkb * bk}")
    if x.dtype not in _MATMUL_DTYPES or pool.dtype != x.dtype:
        raise ValueError(f"dedup_matmul: x {x.dtype} / pool {pool.dtype}; "
                         "the kernel takes float32 or bfloat16 for both")
    if (out_dtype or x.dtype) != x.dtype:
        raise ValueError("dedup_matmul: the kernel writes x's dtype")
    _check_index("dedup_matmul", block_map)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    _check_cuda("dedup_matmul", x2, pool, block_map)
    M = x2.shape[0]
    out = torch.empty((M, nnb * bn), dtype=x.dtype, device=x.device)
    fn = _build.load("dedup_matmul")
    with torch.cuda.device(x.device):
        err = fn(x2.data_ptr(), pool.data_ptr(), block_map.data_ptr(),
                 out.data_ptr(), M, nkb, nnb, bk, bn,
                 _MATMUL_DTYPES[x.dtype], _stream(x.device))
    _launched("dedup_matmul", err)
    return out.reshape(lead + (nnb * bn,))


# --------------------------------------------------------- dedup_embedding --
def dedup_embedding_striped(ids, pool, block_map, width=None):
    """Rows of a 2-D virtual tensor stored as ``(bh, bw)`` blocks.

    ids [B] int32; pool [n_blocks, bh, bw]; block_map [gh, gw] int32.
    Returns [B, width or gw*bw].  On CUDA every column stripe is gathered
    in ONE launch (the reference launches once per stripe and
    concatenates); the result is bit-equal to :func:`ref.
    dedup_embedding_striped`."""
    gh, gw = block_map.shape
    n, bh, bw = pool.shape
    width = gw * bw if width is None else int(width)
    if ids.device.type == "cpu":
        return ref.dedup_embedding_striped(ids, pool, block_map, width)
    if ids.device.type != "cuda":
        raise ValueError(f"dedup_embedding: no kernel for {ids.device}")
    if not 0 < width <= gw * bw:
        raise ValueError(f"dedup_embedding: width {width} outside "
                         f"(0, {gw * bw}]")
    _check_index("dedup_embedding", ids)
    _check_index("dedup_embedding", block_map)
    _check_cuda("dedup_embedding", ids, pool, block_map)
    B = ids.shape[0]
    out = torch.empty((B, width), dtype=pool.dtype, device=pool.device)
    if B == 0:
        return out
    fn = _build.load("dedup_embedding")
    with torch.cuda.device(ids.device):
        err = fn(pool.data_ptr(), ids.data_ptr(), block_map.data_ptr(),
                 out.data_ptr(), B, bh, bw, gw, width, pool.element_size(),
                 _stream(ids.device))
    _launched("dedup_embedding", err)
    return out


def dedup_embedding(ids, pool, row_block_map):
    """ids [...] -> [..., D] rows of the virtual embedding.

    pool [n_distinct, bv, D]; row_block_map [V/bv] int32: the striped
    gather with one stripe of width D."""
    lead = ids.shape
    out = dedup_embedding_striped(ids.reshape(-1), pool,
                                  row_block_map.reshape(-1, 1))
    return out.reshape(lead + (out.shape[-1],))
