"""Mixture-of-Experts block: top-k routing with capacity.

Counterpart of ``repro.models.moe``.  Dispatch is scatter/gather-based
(no [T, E, C] one-hot): token -> (expert, slot) assignments come from
per-expert running counts, and tokens past an expert's capacity are
dropped into one overflow row (slot ``E*C``), which is discarded.
Experts run as one grouped product over the expert axis, summed in fp32.
Supports arctic's parallel dense-FFN residual (``dense_ff``).

What differs from the reference: ``jax.lax.top_k`` puts the lower index
first on ties and ``torch.topk`` promises no order, so the selection is a
stable descending sort; the dispatch scatter is ``index_copy_``, whose
order among the dropped tokens (all written to the overflow row) is
unspecified, which no kept slot can see.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
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


def route(xt, p, moe: MoEConfig):
    """(gate values [T, K] renormalised, slots [T, K], keeps [T, K], C):
    each token's k experts and its slot ``e*C + position`` in the
    dispatch buffer, ``E*C`` where the expert is full."""
    T = xt.shape[0]
    E, K = moe.num_experts, moe.top_k
    C = _capacity(moe, T)
    router_logits = dot(xt, p["router"].to(xt.dtype))               # [T, E]
    probs = torch.softmax(router_logits.to(F32), dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                           # [T, K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # (expert, slot) assignment with running per-expert counts
    counts = torch.zeros((E,), dtype=torch.int64, device=xt.device)
    slot_list, keep_list = [], []
    for j in range(K):
        e = gate_idx[:, j]                                          # [T]
        onehot = F.one_hot(e, E)                                    # [T, E]
        pos = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]     # [T, E]
        slot_in_e = torch.gather(pos, 1, e[:, None])[:, 0]
        counts = counts + onehot.sum(dim=0)
        keep = slot_in_e < C
        slot_list.append(torch.where(keep, e * C + slot_in_e,
                                     torch.full_like(e, E * C)))    # E*C=drop
        keep_list.append(keep)
    return (gate_vals, torch.stack(slot_list, dim=1),
            torch.stack(keep_list, dim=1), C)


def _edot(a, b):
    """Grouped product over the expert axis, fp32 result (bf16 operands
    widened: their products are exact in fp32)."""
    return torch.matmul(a.to(F32), b.to(F32))


def moe_block(x, p, moe: MoEConfig, act: str, gated: bool):
    """x: [B, S, D] (or [B, 1, D] decode) -> same shape."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, K = moe.num_experts, moe.top_k
    gate_vals, slots, keeps, C = route(xt, p, moe)

    # dispatch: scatter token rows into [E*C + 1, D] (dropped -> last row)
    disp = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    tok_rows = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    disp.index_copy_(0, slots.reshape(-1), tok_rows)
    xe = disp[: E * C].reshape(E, C, D)

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
    yt = torch.einsum("tkd,tk->td", per_k.to(F32), w.to(F32)).to(x.dtype)

    if moe.dense_ff and "dw1" in p:                                 # arctic
        dense_p = {"w1": p["dw1"], "w2": p["dw2"]}
        if gated:
            dense_p["w3"] = p["dw3"]
        yt = yt + mlp(xt, dense_p, act, gated).to(x.dtype)
    return yt.reshape(B, S, D)
