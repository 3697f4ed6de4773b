"""The port's MoE block against the JAX package's.

The same numpy router, experts and tokens go through
``repro.models.moe.moe_block`` and ``repro_torch.models.moe.moe_block``:
prefill and decode token counts (so two capacities), a capacity that
drops tokens, arctic's parallel dense FFN on and off, gated and plain
experts, and a router with tied columns.  The outputs agree within 1e-5
(fp32; summation order differs), and the port's kept slots equal the
reference's assignment — ``jax.lax.top_k``'s experts, lower index first
on a tie, slots handed out in token order, round by round — exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

torch.set_num_threads(2)

D, F = 16, 24


def _params(E, rng, dense_ff=0, gated=True, tie=False):
    p = {"router": rng.standard_normal((D, E)) * 0.5,
         "ew1": rng.standard_normal((E, D, F)) * 0.2,
         "ew2": rng.standard_normal((E, F, D)) * 0.2}
    if gated:
        p["ew3"] = rng.standard_normal((E, D, F)) * 0.2
    if dense_ff:
        p["dw1"] = rng.standard_normal((D, dense_ff)) * 0.2
        p["dw2"] = rng.standard_normal((dense_ff, D)) * 0.2
        if gated:
            p["dw3"] = rng.standard_normal((D, dense_ff)) * 0.2
    if tie:                     # experts 1 and 2 (and 0 and 3) score alike
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 0]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _reference_slots(probs, E, K, C):
    """The reference's assignment, written out: top-k by
    ``jax.lax.top_k``, then slot e*C + (tokens already given e), E*C
    where e is full."""
    _, idx = jax.lax.top_k(jnp.asarray(probs), K)
    idx = np.asarray(idx)
    counts = np.zeros(E, np.int64)
    slots = np.empty(idx.shape, np.int64)
    for j in range(K):
        for t in range(idx.shape[0]):
            e = idx[t, j]
            slots[t, j] = e * C + counts[e] if counts[e] < C else E * C
            counts[e] += 1
    return slots


CASES = {
    # name: (B, S, E, K, capacity_factor, dense_ff, gated, act, tie)
    "prefill": (2, 16, 4, 2, 2.0, 0, True, "silu", False),
    "decode": (4, 1, 4, 2, 2.0, 0, True, "silu", False),
    "drops": (4, 24, 4, 2, 0.25, 0, True, "silu", False),
    "dense_ff": (2, 12, 4, 2, 1.25, 32, True, "silu", False),
    "plain_gelu": (2, 12, 6, 2, 1.25, 0, False, "gelu", False),
    "dense_ff_plain_drops": (3, 20, 8, 3, 0.5, 16, False, "gelu", False),
    "tie": (2, 16, 4, 2, 0.5, 0, True, "silu", True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_block_matches_jax(name):
    B, S, E, K, cf, dff, gated, act, tie = CASES[name]
    rng = np.random.default_rng(len(name))
    p = _params(E, rng, dff, gated, tie)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, d_ff=F, capacity_factor=cf,
              dense_ff=dff)
    want = jmoe.moe_block(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()},
                          JMoEConfig(**kw), act, gated)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = moe.moe_block(torch.from_numpy(x), tp, MoEConfig(**kw), act, gated)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5,
                               atol=1e-5)

    # the kept slots, exactly
    T = B * S
    C = moe._capacity(MoEConfig(**kw), T)
    assert C == jmoe._capacity(JMoEConfig(**kw), T)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, D)) @ p["router"],
                           axis=-1)
    want_slots = _reference_slots(np.asarray(probs), E, K, C)
    _, slots, keeps, _ = moe.route(torch.from_numpy(x.reshape(T, D)), tp,
                                   MoEConfig(**kw))
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    np.testing.assert_array_equal(keeps.numpy(), want_slots < E * C)
    if name.endswith("drops") or name == "tie":
        assert (~keeps).any()              # the capacity dropped tokens


def test_prefill_and_decode_capacities_differ():
    m = MoEConfig(num_experts=4, top_k=2, d_ff=F, capacity_factor=2.0)
    assert moe._capacity(m, 32) == 32 and moe._capacity(m, 4) == 8
    for T in (1, 4, 32, 4096):
        assert moe._capacity(m, T) == jmoe._capacity(JMoEConfig(
            num_experts=4, top_k=2, d_ff=F, capacity_factor=2.0), T)


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert ti.tolist() == [[1, 2, 3], [0, 1, 2], [0, 2, 1]]
