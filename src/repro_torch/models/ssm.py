"""Mamba-2 (SSD: state-space duality) mixer, chunked.

Counterpart of ``repro.models.ssm``.  The SSD recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,  y_t = C_t h_t + D x_t  is
evaluated chunk-parallel (arXiv:2405.21060): intra-chunk terms as a
masked quadratic form, inter-chunk through the per-chunk states (the
reference's ``lax.scan`` is a Python loop over chunks here).
Single-token decode keeps the dense state ``[B, H, hd, N]`` plus the
causal-conv tail.

The reference computes SSD in plain ``jnp`` outside any Pallas kernel,
so this module is plain torch, with the reference's casts: the
projection cast to x's dtype, ``dt`` through softplus in fp32 with
``dt_bias``, ``A = -exp(A_log)``, the state in fp32, ``y`` cast to x's
dtype before the gate.

Layout: d_inner = expand * d_model; H = d_inner / head_dim heads;
B/C are shared per group (n_groups, typically 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .layers import causal_conv1d, dot, rms_norm

F32 = torch.float32


def ssm_dims(d_model: int, s: SSMConfig) -> Tuple[int, int, int]:
    """(d_inner, num_heads, conv_channels)."""
    din = s.expand * d_model
    nheads = din // s.head_dim
    conv_ch = din + 2 * s.n_groups * s.d_state
    return din, nheads, conv_ch


def _split_proj(zxbcdt, d_model, s: SSMConfig):
    din, nheads, _ = ssm_dims(d_model, s)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * gn, nheads], dim=-1)
    return z, xbc, dt          # z: [..,din], xbc: [..,din+2gn], dt: [..,H]


def ssd_chunked(xh, dt, A, Bm, Cm, Dp, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """Chunk-parallel SSD.

    xh [B,S,H,hd]; dt [B,S,H] (softplus applied); A [H] (<0);
    Bm, Cm [B,S,G,N]; Dp [H].  Returns (y [B,S,H,hd] fp32, final_state
    [B,H,hd,N] fp32).  The last chunk is zero-padded when S % chunk."""
    B, S, H, hd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G                                   # heads per group
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q

    state = torch.zeros((B, H, hd, N), dtype=F32, device=xh.device) \
        if state0 is None else state0
    Af = A.to(F32)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xf = xh[:, sl].to(F32)
        dtq = dt[:, sl].to(F32)
        Bq, Cq = Bm[:, sl].to(F32), Cm[:, sl].to(F32)
        dA = dtq * Af                            # [B,Q,H]
        cum = torch.cumsum(dA, dim=1)            # inclusive cumsum
        # intra-chunk: h_i += sum_{j<=i} e^{cum_i-cum_j} dt_j B_j x_j.  exp
        # overflows to inf above the diagonal: select, never multiply by
        # the mask (inf * 0 = nan)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B,Q,Q,H]
        L = torch.where(mask[None, :, :, None], torch.exp(diff),
                        torch.zeros((), dtype=F32, device=xh.device))
        CB = torch.einsum("bqgn,bpgn->bqpg", Cq, Bq)         # [B,Q,Q,G]
        CB = torch.repeat_interleave(CB, R, dim=3)           # [B,Q,Q,H]
        W = CB * L * dtq[:, None, :, :]                      # weight for x_j
        y_diag = torch.einsum("bqph,bphd->bqhd", W, xf)
        # inter-chunk: h_i also carries e^{cum_i} * S_in
        Cq_h = torch.repeat_interleave(Cq, R, dim=2)         # [B,Q,H,N]
        y_off = torch.einsum("bqhn,bhdn->bqhd", Cq_h, state)
        y_off = y_off * torch.exp(cum)[:, :, :, None]
        ys.append(y_diag + y_off)
        # state update: S_out = e^{cum_Q} S_in
        #                       + sum_j e^{cum_Q-cum_j} dt_j B_j (x) x_j
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # [B,Q,H]
        Bq_h = torch.repeat_interleave(Bq, R, dim=2)         # [B,Q,H,N]
        contrib = torch.einsum("bqh,bqhd,bqhn->bhdn", decay_to_end * dtq,
                               xf, Bq_h)
        state = torch.exp(cum[:, -1, :])[:, :, None, None] * state + contrib
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + Dp.to(F32)[None, None, :, None] * xh[:, :S].to(F32)
    return y, state


def ssd_decode(x1, dt1, A, B1, C1, Dp, state):
    """Single-token SSD update.

    x1 [B,H,hd]; dt1 [B,H]; B1,C1 [B,G,N]; state [B,H,hd,N] fp32."""
    Bsz, H, hd = x1.shape
    G = B1.shape[1]
    R = H // G
    dA = torch.exp(dt1.to(F32) * A.to(F32))                  # [B,H]
    B_h = torch.repeat_interleave(B1.to(F32), R, dim=1)      # [B,H,N]
    C_h = torch.repeat_interleave(C1.to(F32), R, dim=1)
    contrib = (dt1.to(F32)[:, :, None, None]
               * x1.to(F32)[..., None] * B_h[:, :, None, :])
    state = dA[:, :, None, None] * state + contrib
    y = torch.einsum("bhdn,bhn->bhd", state, C_h)
    y = y + Dp.to(F32)[None, :, None] * x1.to(F32)
    return y, state


def mamba_mixer(x, p, d_model: int, s: SSMConfig,
                conv_state=None, ssm_state=None, decode: bool = False):
    """Full mamba-2 block: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Prefill: x [B,S,D], returns (y, (conv_state, ssm_state)).
    Decode: x [B,1,D] with states threaded through."""
    din, H, conv_ch = ssm_dims(d_model, s)
    gn = s.n_groups * s.d_state
    zxbcdt = dot(x, p["in_proj"].to(x.dtype)).to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_model, s)
    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))

    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [din, gn, gn], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    xh = xs.reshape(Bsz, S, H, s.head_dim)
    Bm = Bm.reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(Bsz, S, s.n_groups, s.d_state)

    if decode:
        y, ssm_state = ssd_decode(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                  p["Dp"], ssm_state)
        y = y[:, None]                                       # [B,1,H,hd]
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, p["Dp"], s.chunk,
                                   ssm_state)
    y = y.reshape(Bsz, S, din).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p["ssm_norm"])
    out = dot(y, p["out_proj"].to(x.dtype)).to(x.dtype)
    return out, (conv_state, ssm_state)
