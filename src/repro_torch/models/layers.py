"""Shared building blocks of the model zoo, in plain PyTorch.

Counterpart of ``repro.models.layers``, with the same conventions:

  * params are plain dicts of tensors (the weights the serving engine
    reassembled on the device), per-layer params stacked on a leading
    layer axis or given as one dict a layer;
  * matrix products return fp32 (``preferred_element_type=F32`` in the
    reference): bf16 operands are multiplied exactly and summed in fp32;
    on the card an fp32 operand against a bf16 one is split exactly into
    three bf16 parts and summed the same way (:func:`dot_route`).

``mlp`` calls the sharding ``hint`` at the reference's ``act_ff`` site
(``distributed.sharding``: the identity unless a recipe is active and
the activation is a DTensor).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..distributed.sharding import (all_reduce, from_local, hint,
                                    is_dtensor, local, reshape, shard_range)
from ..kernels import ops

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


#: the fewest rows of an fp32 activation that take the split3 route.  On
#: the H100 a product of a few rows (a decode step's batch) is bound by
#: the host's launches: the split route takes 89 us of host time a call
#: against the FFMA GEMM's 33 us, and saves little device time (at 4
#: rows 0.111 ms against 0.140 at K = N = 4,096, 0.016 against 0.021 at
#: 1,600).  Run eagerly, FFMA is still the faster at 256 rows and
#: K = N = 1,600 (0.048 ms against 0.093); from 512 rows on the split
#: route is, at both widths (0.153 against 0.437, 0.077 against 0.112)
SPLIT_MIN_ROWS = 512


def dot_route(a, b) -> str:
    """How :func:`dot` multiplies ``a`` and ``b``.

    "split3": ``a`` fp32 (the activation) of at least
    :data:`SPLIT_MIN_ROWS` rows and ``b`` bf16 and 2-D (the weight), both
    plain CUDA tensors, neither needing a gradient: :func:`split3_dot`,
    the sum of the same exact products as an fp32 GEMM, on the tensor
    cores.  "fp32": every other product that promotes to fp32
    (``torch.matmul`` in fp32; a DTensor takes :class:`LowPrecisionDot`
    in fp32).  "bf16": a product in one low precision
    (:class:`LowPrecisionDot`).  CPU tensors, operands that need a
    gradient (training, the VJP), DTensors and products of fewer rows
    keep the fp32 route: the split has no backward, is exact only
    against a bf16 operand, and costs more than it saves on a few
    rows."""
    if torch.promote_types(a.dtype, b.dtype) != F32:
        return "bf16"
    if (a.dtype == F32 and b.dtype == torch.bfloat16 and b.dim() == 2
            and a.device.type == b.device.type == "cuda"
            and math.prod(a.shape[:-1]) >= SPLIT_MIN_ROWS
            and not (is_dtensor(a) or is_dtensor(b))
            and not (a.requires_grad or b.requires_grad)):
        return "split3"
    return "fp32"


@contextlib.contextmanager
def _fp32_reduction():
    """cuBLAS's bf16 GEMMs with every reduction in fp32 (no split-K sum
    in reduced precision) inside the block."""
    m = torch.backends.cuda.matmul
    prev = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = prev


def split3_dot(a, b):
    """``a @ b`` of an fp32 ``a`` and a 2-D bf16 ``b``, in fp32, as one
    bf16 GEMM: ``a`` is split exactly into three bf16 parts
    (:func:`kernels.ops.split_bf16x3`, one pass) laid along K, smallest
    first, ``b`` is stacked three times along K, and cuBLAS sums the
    exact bf16 products in fp32.  The sum is the fp32 GEMM's, in another
    order and with the tensor cores' accumulation, which cuts what falls
    below the running sum's last bits: on the H100, at the benchmark
    cells' ``wo`` products, its distance from float64 is 3.9 and 2.3
    times the FFMA GEMM's, where the same GEMM over x0 + x1 alone reads
    11 and 15 times.  On the CPU the plain split and the widened
    ``mm.dtype`` compute the same."""
    K, N = b.shape
    a3 = ops.split_bf16x3(a.reshape(-1, K).contiguous())
    with _fp32_reduction():
        out = torch.mm(a3, torch.cat([b, b, b]), out_dtype=F32)
    return out.reshape(*a.shape[:-1], N)


def dot(a, b):
    """``a @ b`` with an fp32 result, operands promoted as jnp.matmul
    promotes them, by the route :func:`dot_route` picks.  A bf16 product
    is one ``torch.mm(..., out_dtype=F32)`` (:class:`LowPrecisionDot`,
    which carries the reference's gradient): on the card it accumulates
    in fp32 inside cuBLAS, on the CPU its operands are widened first
    (their products are exact in fp32, so the sum is the same math).  An
    fp32 product is ``torch.matmul`` in fp32, or on the card, an fp32
    activation of many rows against a bf16 weight with no gradient,
    :func:`split3_dot`.  DTensors take :class:`LowPrecisionDot` in fp32
    too, for its backward's all-reduce of partial sums."""
    route = dot_route(a, b)
    if route == "split3":
        return split3_dot(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    if route == "fp32" and not is_dtensor(a):
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
