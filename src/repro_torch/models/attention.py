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

from typing import Optional

import torch
import torch.nn.functional as F

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


def attend(q, k, v, *, causal: bool = True, window: int = 0,
           softcap: float = 0.0, q_offset: int = 0, kv_len=None,
           chunk: int = 1024, scale: Optional[float] = None):
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
    :func:`flash_prefill` (the kernel), CPU tensors :func:`attend`."""
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
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    q_pos = kv_len - 1 if q_pos is None else q_pos

    qg = (q.to(F32) * scale).to(k.dtype).reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32), k.to(F32))
    s = _cap(s, softcap)
    kv_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    valid = kv_pos < kv_len
    if window:
        valid &= (q_pos - kv_pos) < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).to(F32), v.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)
