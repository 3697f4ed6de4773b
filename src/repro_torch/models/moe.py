"""Mixture-of-Experts block: top-k routing with capacity.

Counterpart of ``repro.models.moe``.  Dispatch is scatter/gather-based
(no [T, E, C] one-hot): token -> (expert, slot) assignments come from
per-expert running counts, and tokens past an expert's capacity are
dropped into one overflow row (slot ``E*C``), which is discarded.
Experts run as one grouped product over the expert axis, summed in fp32.
Supports arctic's parallel dense-FFN residual (``dense_ff``).

What differs from the reference: ``jax.lax.top_k`` puts the lower index
first on ties and ``torch.topk`` promises no order, so the selection is a
stable descending sort; the dispatch scatter is ``index_copy`` (out of
place, so autograd carries it), whose order among the dropped tokens
(all written to the overflow row) is unspecified, which no kept slot
can see.
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from torch.distributed.tensor import Replicate

from ..distributed.sharding import (all_reduce, all_reduce_grad, from_local,
                                    hint, is_dtensor, local, parallel_dims,
                                    shard_placements, shard_range)
from .layers import activation, dot, mlp

F32 = torch.float32


def _capacity(moe: MoEConfig, num_tokens: int) -> int:
    c = int(moe.capacity_factor * num_tokens * moe.top_k / moe.num_experts)
    return max(8, -(-c // 8) * 8)          # >=8 and a multiple of 8


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, p, moe: MoEConfig, num_tokens=None, offsets=None):
    """(gate values [T, K] renormalised, slots [T, K], keeps [T, K], C):
    each token's k experts and its slot ``e*C + position`` in the
    dispatch buffer, ``E*C`` where the expert is full.

    A shard of a batch routes as part of the whole batch given
    ``num_tokens``, the batch's token count, which sets C (T by default),
    and ``offsets``, a function from this shard's counts by choice and
    expert [K, E] to the position of each choice's first token in each
    expert [K, E] (by default the counts of the earlier choices; see
    :func:`batch_offsets`)."""
    T = xt.shape[0]
    E, K = moe.num_experts, moe.top_k
    C = _capacity(moe, T if num_tokens is None else num_tokens)
    router_logits = dot(xt, p["router"].to(xt.dtype))               # [T, E]
    probs = torch.softmax(router_logits.to(F32), dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                           # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # (expert, slot) assignment with running per-expert counts
    onehots = [F.one_hot(gate_idx[:, j], E) for j in range(K)]      # [T, E]
    counts = torch.stack([o.sum(dim=0) for o in onehots])           # [K, E]
    start = (torch.cumsum(counts, dim=0) - counts if offsets is None
             else offsets(counts))
    slot_list, keep_list = [], []
    for j in range(K):
        e = gate_idx[:, j]                                          # [T]
        pos = torch.cumsum(onehots[j], dim=0) - 1 + start[j][None, :]
        slot_in_e = torch.gather(pos, 1, e[:, None])[:, 0]
        keep = slot_in_e < C
        slot_list.append(torch.where(keep, e * C + slot_in_e,
                                     torch.full_like(e, E * C)))    # E*C=drop
        keep_list.append(keep)
    return (gate_vals, torch.stack(slot_list, dim=1),
            torch.stack(keep_list, dim=1), C)


def batch_offsets(mesh, tokens):
    """:func:`route`'s ``offsets`` for this rank's shard of a batch
    chunked over the mesh dims ``tokens`` (in mesh order, as
    :func:`shard_placements` lays it out): choice j's first position in
    expert e is the whole batch's count of the choices before j in e plus
    the lower ranks' count of choice j in e, the reference's running
    counts over the whole batch.  One all-gather of [K, E] counts."""
    bw = shard_placements([0 if m in tokens else None
                           for m in range(mesh.ndim)])
    coord = mesh.get_coordinate()
    n, rank = 1, 0
    for m in tokens:
        n *= mesh.shape[m]
        rank = rank * mesh.shape[m] + coord[m]

    def offsets(counts):
        every = from_local(counts[None], mesh, bw,
                           (n,) + tuple(counts.shape)).full_tensor()
        total = every.sum(dim=0)                                    # [K, E]
        return torch.cumsum(total, dim=0) - total + every[:rank].sum(dim=0)
    return offsets


def _edot(a, b):
    """Grouped product over the expert axis, fp32 result (bf16 operands
    widened: their products are exact in fp32)."""
    return torch.matmul(a.to(F32), b.to(F32))


def moe_block(x, p, moe: MoEConfig, act: str, gated: bool):
    """x: [B, S, D] (or [B, 1, D] decode) -> same shape."""
    if is_dtensor(x):
        return _moe_dtensor(x, p, moe, act, gated)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    yt = moe_experts(xt, p, moe, act, gated).to(x.dtype)
    return _dense_residual(yt, xt, p, moe, act, gated).reshape(B, S, D)


def moe_experts(xt, p, moe: MoEConfig, act: str, gated: bool,
                experts=None, num_tokens=None, offsets=None):
    """The routed experts' fp32 output [T, D] for the tokens xt [T, D].
    ``experts`` = (first, count): only those experts run (``p``'s expert
    weights hold just them; routing still sees every expert), and the
    result is their share of the sum, which the caller reduces.
    ``num_tokens`` and ``offsets`` go to :func:`route`."""
    T, D = xt.shape
    E, K = moe.num_experts, moe.top_k
    gate_vals, slots, keeps, C = route(xt, p, moe, num_tokens, offsets)
    if experts is not None:            # other experts' slots -> drop row
        e0, E = experts
        mine = (slots >= e0 * C) & (slots < (e0 + E) * C)
        slots = torch.where(mine, slots - e0 * C,
                            torch.full_like(slots, E * C))

    # dispatch: scatter token rows into [E*C + 1, D] (dropped -> last row)
    tok_rows = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    disp = torch.zeros((E * C + 1, D), dtype=xt.dtype,
                       device=xt.device).index_copy(0, slots.reshape(-1),
                                                    tok_rows)
    xe = hint(disp[: E * C].reshape(E, C, D), "moe_disp")

    # grouped expert FFN
    h = _edot(xe, p["ew1"].to(xe.dtype))
    if gated:
        h = activation(h, act) * _edot(xe, p["ew3"].to(xe.dtype))
    else:
        h = activation(h, act)
    ye = _edot(h.to(xe.dtype), p["ew2"].to(xe.dtype))              # [E, C, D]

    # combine: each token's k expert outputs, weighted by its gates
    ye_flat = torch.cat([ye.reshape(E * C, D),
                         torch.zeros((1, D), dtype=ye.dtype,
                                     device=ye.device)], dim=0)
    per_k = ye_flat[slots.reshape(-1)].reshape(T, K, D)
    w = (gate_vals * keeps).to(per_k.dtype)                         # [T, K]
    return torch.einsum("tkd,tk->td", per_k.to(F32), w.to(F32))


def _dense_residual(yt, xt, p, moe: MoEConfig, act: str, gated: bool):
    """arctic's dense FFN beside the experts, added to their output."""
    if moe.dense_ff and "dw1" in p:
        dense_p = {"w1": p["dw1"], "w2": p["dw2"]}
        if gated:
            dense_p["w3"] = p["dw3"]
        yt = yt + mlp(xt, dense_p, act, gated).to(yt.dtype)
    return yt


def _moe_dtensor(x, p, moe: MoEConfig, act: str, gated: bool):
    """:func:`moe_block` of DTensors, expert parallel without an
    all-to-all: the tokens stay sharded over the batch alone (every rank
    of an expert mesh dim holds the same tokens), the experts stay
    sharded over their axis (their d-dims gathered), each rank routes its
    tokens over all experts and runs :func:`moe_experts` on its own, and
    the shares are all-reduced over the expert mesh dims.  Capacity and
    positions are the whole batch's, as in the reference: C comes from
    the batch's token count, and each rank's positions in an expert are
    offset by the counts of the tokens before its own
    (:func:`batch_offsets`), so every rank keeps and drops the tokens
    the plain block over the whole batch does.  Each rank's dispatch
    buffer is [E_local, C, D] at that C; the ranks' kept slots are
    disjoint, and a rank's buffer holds only its own tokens."""
    mesh = x.device_mesh
    B, S, D = x.shape
    tokens = [m for m, d in enumerate(parallel_dims(x, {0: (B,)}))
              if d == 0]
    # a mesh dim that splits the tokens cannot split the experts too
    ep = [m for m, d in enumerate(parallel_dims(p["ew1"], {
        0: (moe.num_experts,)})) if d == 0 and m not in tokens]
    bw = shard_placements([0 if m in tokens else None
                           for m in range(mesh.ndim)])
    ew = shard_placements([0 if m in ep else None
                           for m in range(mesh.ndim)])
    # each rank's use of a weight covers its own tokens (gradients partial
    # over the batch's mesh dims); the routing's and the experts' inputs
    # reach only its own experts' slots (partial over the experts' too)
    xl = local(x, bw)
    xt = xl.reshape(-1, D)
    rep = [Replicate()] * mesh.ndim
    pl = {k: local(v, ew, tokens) if k in ("ew1", "ew2", "ew3")
          else local(v, rep, tokens + ep if k == "router" else tokens)
          for k, v in p.items()}
    e0, El = shard_range(p["ew1"], 0, ew)
    yt = moe_experts(all_reduce_grad(xt, mesh, ep), pl, moe, act, gated,
                     experts=(e0, El), num_tokens=B * S,
                     offsets=batch_offsets(mesh, tokens))
    yt = all_reduce(yt, mesh, ep).to(x.dtype)
    yt = _dense_residual(yt, xt, pl, moe, act, gated)
    return from_local(yt.reshape(xl.shape), mesh, bw, x.shape)
