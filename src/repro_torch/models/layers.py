"""Shared building blocks of the model zoo, in plain PyTorch.

Counterpart of ``repro.models.layers``, with the same conventions:

  * params are plain dicts of tensors (the weights the serving engine
    reassembled on the device), per-layer params stacked on a leading
    layer axis or given as one dict a layer;
  * matrix products return fp32 (``preferred_element_type=F32`` in the
    reference): bf16 operands are multiplied exactly and summed in fp32.

The reference's sharding ``hint`` is the identity outside a mesh and is
left out.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def dot(a, b):
    """``a @ b`` with an fp32 result, operands promoted as jnp.matmul
    promotes them.  On the card a bf16 product accumulates in fp32 inside
    cuBLAS and writes fp32; elsewhere bf16 operands are widened first
    (their products are exact in fp32, so the sum is the same math)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt == F32 or a.device.type != "cuda":
        return torch.matmul(a.to(F32), b.to(F32))
    a2 = a.to(dt).reshape(-1, a.shape[-1])
    out = torch.mm(a2, b.to(dt), out_dtype=F32)
    return out.reshape(a.shape[:-1] + (b.shape[-1],))


def layer_at(gparams, i: int):
    """Layer ``i`` of a layer group: an entry of a per-layer list, or a
    view of every stacked tensor at index ``i``."""
    if isinstance(gparams, (list, tuple)):
        return gparams[i]
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in gparams.items()}


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.to(F32) \
        + bias.to(F32)
    return out.to(x.dtype)


def norm(x, p, kind: str, eps: float):
    if kind == "layer":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def softcap(x, cap: float):
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.to(F32) / cap)).to(x.dtype)


def rotary(x, positions, theta: float):
    """Apply RoPE.  x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions[..., None].to(F32) * freqs            # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                    # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def activation(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(x, p, act: str, gated: bool):
    """SwiGLU/GeGLU (gated) or plain 2-matmul MLP."""
    h = dot(x, p["w1"])                                   # [.., F] fp32
    if gated:
        h = activation(h, act) * dot(x, p["w3"])
    else:
        h = activation(h, act)
    return dot(h.to(x.dtype), p["w2"]).to(x.dtype)


def embed(tokens, table, scale: bool):
    x = table[tokens.long()]
    if scale:
        # the scale stays in the table's dtype, as in the reference
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(x, table_or_head, tied: bool, cap: float = 0.0):
    w = table_or_head.T if tied else table_or_head
    logits = dot(x, w.to(x.dtype))
    return softcap(logits, cap)


def causal_conv1d(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv used by mamba: x [B,S,C], w [K,C], b [C].

    With ``state`` ([B, K-1, C], the trailing inputs of the previous step)
    this is the streaming/decode form; returns (y, new_state).  The zero
    state and the output are in x's dtype, as in the reference."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xin = torch.cat([state, x], dim=1)                   # [B, S+K-1, C]
    y = sum(xin[:, i: i + x.shape[1]] * w[i] for i in range(k))
    new_state = xin[:, -(k - 1):] if k > 1 else state
    return (y + b).to(x.dtype), new_state
