"""Shared building blocks of the model zoo, in plain PyTorch.

Counterpart of ``repro.models.layers``, with the same conventions:

  * params are plain dicts of tensors (the weights the serving engine
    reassembled on the device), per-layer params stacked on a leading
    layer axis or given as one dict a layer;
  * matrix products return fp32 (``preferred_element_type=F32`` in the
    reference): bf16 operands are multiplied exactly and summed in fp32.

``mlp`` calls the sharding ``hint`` at the reference's ``act_ff`` site
(``distributed.sharding``: the identity unless a recipe is active and
the activation is a DTensor).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..distributed.sharding import (all_reduce, from_local, hint,
                                    is_dtensor, local, reshape, shard_range)

F32 = torch.float32


class LowPrecisionDot(torch.autograd.Function):
    """``a2 @ b`` of two 2-D operands in one low precision (bf16), written
    in fp32, with the reference's VJP of ``jnp.matmul(...,
    preferred_element_type=F32)``: each operand's gradient is the fp32
    cotangent times the other operand widened to fp32, summed in fp32 and
    rounded once to the operand's dtype.  The forward is one ``torch.mm(
    ..., out_dtype=F32)``: cuBLAS's bf16 product on the card, the port's
    CPU kernel for it elsewhere (``distributed.sharding``: the operands
    widened first; their products are exact in fp32, so it is the same
    math); the backward is two fp32 GEMMs."""

    @staticmethod
    def forward(ctx, a2, b):
        ctx.save_for_backward(a2, b)
        if a2.dtype == F32:
            return torch.mm(a2, b)
        return torch.mm(a2, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a2, b = ctx.saved_tensors
        g = _replicated(g).to(F32)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.to(F32).T).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a2.to(F32).T, g).to(b.dtype)
        return ga, gb


def _replicated(g):
    """A DTensor gradient's partial sums all-reduced.  DTensor hands a
    product that fed an all-reduce its gradient as partial sums, and for
    a partial operand its cheapest product gathers the weight and repeats
    the work on every rank of that mesh dim."""
    if not is_dtensor(g) or not any(p.is_partial() for p in g.placements):
        return g
    return g.redistribute(g.device_mesh, [
        Replicate() if p.is_partial() else p for p in g.placements])


def dot(a, b):
    """``a @ b`` with an fp32 result, operands promoted as jnp.matmul
    promotes them.  A bf16 product is one ``torch.mm(..., out_dtype=F32)``
    (:class:`LowPrecisionDot`, which carries the reference's gradient):
    on the card it accumulates in fp32 inside cuBLAS, on the CPU its
    operands are widened first (their products are exact in fp32, so the
    sum is the same math).  DTensors take :class:`LowPrecisionDot` in
    fp32 too, for its backward's all-reduce of partial sums."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt == F32 and not is_dtensor(a):
        return torch.matmul(a.to(F32), b.to(F32))
    a2 = reshape(a.to(dt), -1, a.shape[-1])
    out = LowPrecisionDot.apply(a2, b.to(dt))
    return reshape(out, *a.shape[:-1], b.shape[-1])


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


def token_log_likelihood(logits, labels):
    """log p(label) at every position: log-softmax in fp32 over the last
    axis, the label's entry taken.  DTensor logits whose vocabulary is
    sharded take the vocab-parallel form (:func:`_ll_vocab_parallel`)."""
    if is_dtensor(logits) and any(
            n > 1 and p.is_shard(logits.ndim - 1)
            for p, n in zip(logits.placements, logits.device_mesh.shape)):
        return _ll_vocab_parallel(logits, labels)
    lp = torch.log_softmax(logits.to(F32), dim=-1)
    return torch.gather(lp, -1, labels[..., None].long())[..., 0]


def _ll_vocab_parallel(logits, labels):
    """:func:`token_log_likelihood` of DTensor logits sharded over their
    vocabulary, without gathering it: each rank takes the log-sum-exp and
    the label's logit over its vocabulary shard, and the maxima, sums and
    picked logits are all-reduced over the vocab mesh dims (Megatron's
    vocab-parallel cross entropy); batch and sequence shards stay."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    vocab = [m for m, (p, n) in enumerate(zip(logits.placements, mesh.shape))
             if n > 1 and p.is_shard(last)]
    want = [p if m in vocab or (isinstance(p, Shard) and p.dim < last)
            else Replicate() for m, p in enumerate(logits.placements)]
    rows = [Replicate() if m in vocab else p for m, p in enumerate(want)]
    xd = logits.redistribute(mesh, want)
    x = xd.to_local().to(F32)
    lab = (local(labels, rows) if is_dtensor(labels) else labels).long()
    start, size = shard_range(xd, last)
    mx = all_reduce(x.detach().amax(dim=-1), mesh, vocab, "max")
    se = all_reduce(torch.exp(x - mx[..., None]).sum(dim=-1), mesh, vocab)
    inside = (lab >= start) & (lab < start + size)
    picked = torch.gather(x, -1, (lab - start).clamp(0, size - 1)[..., None])
    picked = all_reduce(torch.where(inside, picked[..., 0],
                                    torch.zeros((), dtype=F32,
                                                device=x.device)),
                        mesh, vocab)
    ll = picked - (mx + torch.log(se))
    return from_local(ll, mesh, rows, tuple(logits.shape[:-1]))


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
    h = hint(h.to(x.dtype), "act_ff")
    return dot(h, p["w2"]).to(x.dtype)


def _embed_dtensor(tokens, table):
    """The lookup in a DTensor table, local to each rank: the table is
    gathered over its vocab (and over its width where the tokens shard
    the same mesh dim), and each rank takes its tokens' rows with the
    plain index, so a one-device mesh runs the plain op."""
    mesh = table.device_mesh
    tp = tokens.placements if is_dtensor(tokens) \
        else [Replicate()] * mesh.ndim
    w_want, x_want = [], []
    for t, w in zip(tp, table.placements):
        if isinstance(t, Shard):
            w_want.append(Replicate())
            x_want.append(Shard(t.dim))
        elif isinstance(w, Shard) and w.dim == 1:
            w_want.append(w)
            x_want.append(Shard(tokens.dim()))
        else:
            w_want.append(Replicate())
            x_want.append(Replicate())
    # each rank looks up other tokens: the table's gradient comes back
    # as partial sums over the mesh dims that shard them
    w = local(table, w_want,
              [m for m, t in enumerate(tp) if isinstance(t, Shard)])
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    shape = tuple(tokens.shape) + (table.shape[1],)
    return from_local(w[ids.long()], mesh, x_want, shape)


def embed(tokens, table, scale: bool):
    x = _embed_dtensor(tokens, table) if is_dtensor(table) \
        else table[tokens.long()]
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
