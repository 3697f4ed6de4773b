"""Plain PyTorch versions of the dedup kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref``.  They run on any device: the CPU
tests use them as the port's compute path, and ``chip_smoke.py`` holds
the hand-written CUDA kernels against them on the card.  The kernels
take int32 ids and maps; torch indexing wants int64, so the conversion
happens here and never in a kernel's interface.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def materialize_virtual(pool, block_map, K: int, N: int):
    """pool [n_distinct, bk, bn] + block_map [K/bk, N/bn] -> dense W [K, N]."""
    nkb, nnb = block_map.shape
    bk, bn = pool.shape[1], pool.shape[2]
    blocks = pool[block_map.reshape(-1).long()]          # [nkb*nnb, bk, bn]
    W = (blocks.reshape(nkb, nnb, bk, bn)
               .permute(0, 2, 1, 3)
               .reshape(nkb * bk, nnb * bn))
    return W[:K, :N]


def dedup_matmul(x, pool, block_map, out_dtype=None):
    """x [..., K] @ W_virtual[K, N] with an fp32 accumulator (paper
    Sec. 2.2 FFNN inference through the dedup block map)."""
    K = block_map.shape[0] * pool.shape[1]
    N = block_map.shape[1] * pool.shape[2]
    W = materialize_virtual(pool, block_map, K, N).to(x.dtype)
    y = torch.matmul(x.to(F32), W.to(F32))
    return y.to(out_dtype or x.dtype)


def dedup_embedding(ids, pool, row_block_map, d_model: int):
    """Embedding lookup from a deduplicated row-block pool.

    pool [n_distinct, bv, D]; row_block_map [V/bv] -> distinct id.
    ids [B] -> [B, d_model].
    """
    bv = pool.shape[1]
    ids = ids.long()
    return pool[row_block_map.long()[ids // bv], ids % bv, :d_model]


def dedup_embedding_striped(ids, pool, block_map, width=None):
    """Rows of a 2-D virtual tensor stored as ``(bh, bw)`` blocks.

    ids [B]; pool [n_blocks, bh, bw]; block_map [gh, gw] -> [B, width].
    Row ``r``'s stripe ``j`` is row ``r % bh`` of block
    ``block_map[r // bh, j]``; the stripes are laid side by side and the
    ragged last one is trimmed to ``width``.
    """
    n, bh, bw = pool.shape
    gw = block_map.shape[1]
    ids = ids.long()
    flat_rows = pool.reshape(n * bh, bw)
    blk = block_map.long()[ids // bh]                      # [B, gw]
    out = flat_rows[blk * bh + (ids % bh)[:, None]]        # [B, gw, bw]
    out = out.reshape(ids.shape[0], gw * bw)
    return out if width is None else out[:, :width]
