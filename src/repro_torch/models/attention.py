"""Attention: GQA/MHA with logit softcap and sliding window.

Counterpart of ``repro.models.attention``.  Three entry points:

  * :func:`attend` — chunked online-softmax attention in plain torch, a
    line-for-line port of the reference (its casts included: q is scaled
    in fp32 and cast to k's dtype, p is cast to v's dtype before the
    product with v), so a model run through it computes what the JAX
    model computes;
  * :func:`prefill_attend` — attention of a whole prompt (causal, or
    not for an encoder and a cross-attention): the
    hand-written ``flash_attention`` kernel (:func:`flash_prefill`) for
    CUDA tensors, ``attend`` for CPU tensors (a CUDA tensor never falls
    back to ``attend``; a caller asks for it by name with
    ``kernel=False``, as the plain oracle);
  * :func:`decode_attend` — one-token decode against a (partially
    filled) KV cache.

Shapes: q [B, Sq, H, hd]; k, v [B, Skv, K, hd]; H = K * G (GQA groups).
Window sizes and cache lengths are Python ints here (the reference's are
traced scalars inside a layer scan).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import (all_reduce, from_local, is_dtensor,
                                    local, parallel_dims, shard_placements,
                                    shard_range)
from ..kernels import ops

F32 = torch.float32
NEG_INF = -2.0e38


def _mask(q_pos, kv_pos, causal: bool, window: int, kv_len):
    """[Sq, C] boolean validity mask (window 0 = global)."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    if kv_len is not None:
        m &= kv_pos[None, :] < kv_len
    return m


def _cap(s, cap: float):
    if cap:
        s = cap * torch.tanh(s / cap)
    return s


def _attend_dtensor(q, k, v, **kw):
    """:func:`attend` of DTensors, local to each rank: batch and heads
    stay sharded where q has them sharded, everything else is gathered
    first (a sequence-parallel prompt), and each rank attends over its
    shard with the plain version.  With fewer kv heads than a mesh dim
    shards q's heads over (GQA), k and v are gathered over it and each
    rank keeps the kv heads its q heads read (their gradients come back
    as partial sums)."""
    mesh = q.device_mesh
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    G = H // K
    dims = parallel_dims(q, {0: (B,), 2: (H,)})
    heads = [m for m, d in enumerate(dims) if d == 2]
    nh = math.prod(mesh.shape[m] for m in heads)
    hl = H // nh                                   # q heads a rank
    kv_dims = list(dims)
    if K % nh:
        if len(heads) == 1 and (hl % G == 0 or G % hl == 0):
            kv_dims[heads[0]] = None               # gather; slice below
        else:
            dims = kv_dims = [None if d == 2 else d for d in dims]
            heads, hl = [], H
    sliced = [m for m in heads if kv_dims[m] is None]
    want = shard_placements(dims)
    ql = local(q, want)
    kl, vl = (local(t, shard_placements(kv_dims), sliced) for t in (k, v))
    if sliced:
        h0 = mesh.get_coordinate()[heads[0]] * hl
        k0, k1 = h0 // G, (h0 + hl - 1) // G + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    return from_local(attend(ql, kl, vl, **kw), mesh, want, q.shape)


def attend(q, k, v, *, causal: bool = True, window: int = 0,
           softcap: float = 0.0, q_offset: int = 0, kv_len=None,
           chunk: int = 1024, scale: Optional[float] = None):
    if is_dtensor(q):
        return _attend_dtensor(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               kv_len=kv_len, chunk=chunk, scale=scale)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5

    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = Skv
    nc = (Skv + pad) // chunk

    qg = (q.to(F32) * scale).to(k.dtype).reshape(B, Sq, K, G, hd)
    q_pos = q_offset + torch.arange(Sq, dtype=torch.int32, device=q.device)
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=F32, device=q.device)
    for ci in range(nc):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kv_pos = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                           device=q.device)
        # operands in their storage dtype, products summed in fp32
        s = torch.einsum("bqkgd,bckd->bkgqc", qg.to(F32), kb.to(F32))
        s = _cap(s, softcap)
        valid = _mask(q_pos, kv_pos, causal, window, kv_len)
        s = torch.where(valid[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(vb.dtype).to(F32), vb.to(F32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """The kernel route of :func:`prefill_attend`, with the reference's
    roundings: q is scaled in fp32 and cast to k's dtype (``attend``'s
    ``qg``), ``flash_attention`` runs with scale 1 and writes its fp32
    accumulator in q's dtype, with no second cast.  CPU tensors reach the
    kernel's plain version (the CPU tests' way onto this route)."""
    qs = (q.to(F32) * q.shape[-1] ** -0.5).to(k.dtype)
    return ops.flash_attention(qs, k, v, causal=causal, window=window,
                               softcap=softcap, scale=1.0, out_dtype=q.dtype)


def prefill_attend(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, kernel: bool = True):
    """Attention of a whole prompt: causal self-attention (q, k, v over
    the same positions), or with ``causal=False`` an encoder's
    self-attention or a cross-attention (Sq != Skv).  CUDA tensors take
    :func:`flash_prefill` (the kernel), CPU tensors :func:`attend`.  The
    kernel has no backward and raises on inputs that need a gradient;
    a loss asks for ``kernel=False`` (``attend`` under autograd, as the
    reference differentiates its ``attend``)."""
    if kernel and q.device.type == "cuda":
        return flash_prefill(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap)


def decode_attend(q, k, v, *, kv_len: int, window: int = 0,
                  softcap: float = 0.0, q_pos: Optional[int] = None,
                  scale: Optional[float] = None):
    """One-token decode: q [B, 1, H, hd] against cache k/v [B, S, K, hd].

    ``kv_len`` is the filled length; ``q_pos`` the absolute position of
    the query token (defaults to kv_len - 1 after append)."""
    kw = dict(kv_len=kv_len, window=window, softcap=softcap, q_pos=q_pos,
              scale=scale)
    if is_dtensor(k):
        return _decode_attend_dtensor(q, k, v, **kw)
    B, _, H, hd = q.shape
    p = torch.softmax(_decode_scores(q, k, **kw), dim=-1)
    return _decode_pv(p, v).reshape(B, 1, H, hd).to(q.dtype)


def _decode_scores(q, k, *, kv_len: int, window: int, softcap: float,
                   q_pos: Optional[int], scale: Optional[float],
                   start: int = 0):
    """[B, K, G, S] fp32 scores of the query token against the cache
    positions ``start`` .. ``start + S`` that ``k`` holds, masked from
    ``kv_len`` on and outside the window."""
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    q_pos = kv_len - 1 if q_pos is None else q_pos

    qg = (q.to(F32) * scale).to(k.dtype).reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32), k.to(F32))
    s = _cap(s, softcap)
    kv_pos = torch.arange(start, start + S, dtype=torch.int32,
                          device=q.device)
    valid = kv_pos < kv_len
    if window:
        valid &= (q_pos - kv_pos) < window
    return torch.where(valid, s, NEG_INF)


def _decode_pv(p, v):
    """[B, K, G, hd] fp32: the probabilities (cast to v's dtype, as the
    reference casts them) times v."""
    return torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).to(F32), v.to(F32))


def _decode_attend_dtensor(q, k, v, **kw):
    """:func:`decode_attend` of DTensors, split-KV (flash decoding): where
    the cache is sharded over its sequence, each rank scores its chunk,
    and the maxima, the sums and the probabilities' products with v are
    all-reduced over the sequence's mesh dims; batch stays sharded where
    the cache has it sharded; the rest is gathered first.  With no
    sequence shard it is the plain version on each rank's batch shard."""
    mesh = k.device_mesh
    B, _, H, hd = q.shape
    dims = parallel_dims(k, {0: (B,), 1: (k.shape[1],)})
    q_want = shard_placements([0 if d == 0 else None for d in dims])
    kd, vd = (t.redistribute(mesh, shard_placements(dims)) for t in (k, v))
    ql = q.redistribute(mesh, q_want).to_local()
    split = [m for m, d in enumerate(dims) if d == 1]
    if not split:
        out = decode_attend(ql, kd.to_local(), vd.to_local(), **kw)
    else:
        s = _decode_scores(ql, kd.to_local(), start=shard_range(kd, 1)[0],
                           **kw)
        m = all_reduce(s.amax(dim=-1), mesh, split, "max")
        e = torch.exp(s - m[..., None])
        p = e / all_reduce(e.sum(dim=-1), mesh, split)[..., None]
        out = all_reduce(_decode_pv(p, vd.to_local()), mesh, split)
        out = out.reshape(ql.shape[0], 1, H, hd).to(q.dtype)
    return from_local(out, mesh, q_want, q.shape)
