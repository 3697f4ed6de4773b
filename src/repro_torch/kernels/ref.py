"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Counterparts of ``repro.kernels.ref``.  They run on any device: the CPU
tests use them as the port's compute path, and ``chip_smoke.py`` holds
the hand-written CUDA kernels against them on the card.  The kernels
take int32 ids and maps; torch indexing wants int64, so the conversion
happens here and never in a kernel's interface.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -2.0e38


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


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, out_dtype=None):
    """q [B, Sq, H, hd]; k, v [B, Skv, K, hd] -> [B, Sq, H, hd] in
    ``out_dtype`` (default q's dtype).

    fp32 throughout, with the finite ``-2e38`` mask: a row whose every
    key is masked gets ``p = 1`` for each key, i.e. the mean of v.  The
    fp32 result is cast once, to ``out_dtype``."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    qg = (q.to(F32) * scale).reshape(B, Sq, Kh, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(F32))
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= qp >= kp
    if window:
        m &= (qp - kp) < window
    s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(F32))
    return o.reshape(B, Sq, H, hd).to(out_dtype or q.dtype)


#: a hash whose exact value lies closer than this to a bucket edge may floor
#: to either bucket under two fp32 summation orders (see :func:`lsh_edges`)
LSH_EDGE_TOL = 1e-4


def lsh_signature(blocks, proj, bias, r: float):
    """blocks [n, dim] -> int32 signatures [n, num_hashes] (Sec. 4.2.2):
    ``floor((blocks @ proj + bias) / r)`` in fp32."""
    h = torch.floor((blocks.to(F32) @ proj.to(F32) + bias.to(F32)) / r)
    return h.to(torch.int32)


def lsh_edges(blocks, proj, bias, r: float, tol: float = LSH_EDGE_TOL):
    """bool [n, num_hashes]: where ``(blocks @ proj + bias) / r``, taken in
    fp64, lies within ``tol`` of an integer.

    There two fp32 routines that sum in different orders (numpy's batched
    and per-block products among them) may floor to neighbouring buckets;
    everywhere else their signatures must be equal."""
    v = (blocks.double() @ proj.double() + bias.double()) / r
    return (v - torch.round(v)).abs() < tol
