"""The prefill-attention rounding repair, on the CPU.

The reference's ``attend`` scales q in fp32, casts it to k's dtype
(``qg``), keeps its accumulator in fp32 and returns it in q's dtype; the
model's ``wo`` product then runs in fp32.  The port's kernel route
(``models.attention.flash_prefill``, which ``prefill_attend`` takes for
CUDA tensors) reaches ``flash_attention``'s plain version here, because
the tensors lie on the CPU.  With q in fp32 and k, v in bf16 (the model's
prefill dtypes):

  * the bf16 q the kernel receives is the reference's ``qg`` bit for bit;
  * its result is fp32 and within 2e-6 (fp32 summation order) of the
    reference's plain flash function of that ``qg`` (scale 1);
  * against ``attend`` itself it is within 6e-3: ``attend`` rounds p to
    bf16 before the product with v and the plain version does not (the
    reference's own flash kernel does not either);
  * the route before the repair (unscaled q cast to bf16, the scale on
    the fp32 scores, the result rounded to bf16) misses the reference's
    flash function by the bf16 roundings, above 1e-3.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import attend as jattend
from repro_torch.kernels import ops
from repro_torch.models import attention

torch.set_num_threads(2)

#: (B, S, H, K, hd, window, softcap): hd 128 and 64, whose scales
#: (128 ** -0.5, 64 ** -0.5 = 1/8) are and are not powers of two
CASES = [(2, 64, 4, 2, 128, 0, 0.0),
         (1, 96, 4, 4, 64, 16, 30.0),
         (2, 48, 8, 2, 128, 0, 50.0)]
#: fp32 summation order: torch's einsum against jnp's
SUM_ORDER_TOL = 2e-6
#: attend's bf16 rounding of p (2**-9 of each p) carried through p v:
#: 2.6e-3 to 3.6e-3 on these inputs
P_ROUNDING_TOL = 6e-3


def _inputs(B, S, H, K, hd):
    rng = np.random.default_rng(hd + S)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, hd)).astype(np.float32)
            .astype(ml_dtypes.bfloat16) for _ in range(2))
    tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16()
              for a in (k, v))
    return q, k, v, torch.from_numpy(q), tk, tv


@pytest.mark.parametrize("B,S,H,K,hd,window,cap", CASES)
def test_kernel_route_rounds_like_the_reference(monkeypatch, B, S, H, K, hd,
                                                window, cap):
    q, k, v, tq, tk, tv = _inputs(B, S, H, K, hd)
    kw = dict(causal=True, window=window, softcap=cap)
    seen = {}
    flash = ops.flash_attention

    def spy(qs, *a, **k_):
        seen["qs"] = qs
        return flash(qs, *a, **k_)

    monkeypatch.setattr(ops, "flash_attention", spy)
    got = attention.flash_prefill(tq, tk, tv, window=window, softcap=cap)
    monkeypatch.undo()
    assert got.dtype == torch.float32 and got.shape == tq.shape
    qg = (jnp.asarray(q) * hd ** -0.5).astype(jnp.bfloat16)
    np.testing.assert_array_equal(seen["qs"].float().numpy(),
                                  np.asarray(qg.astype(jnp.float32)))
    # the reference's flash function of qg, k and v (fp32 math, scale 1)
    want = np.asarray(jref.flash_attention(
        qg.astype(jnp.float32), jnp.asarray(k).astype(jnp.float32),
        jnp.asarray(v).astype(jnp.float32), scale=1.0, **kw))
    got = got.numpy()
    assert np.abs(got - want).max() <= SUM_ORDER_TOL
    # the reference model's attend
    model = np.asarray(jattend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw))
    assert model.dtype == np.float32
    assert np.abs(got - model).max() <= P_ROUNDING_TOL
    # the route before the repair
    before = ops.flash_attention(tq.to(tk.dtype), tk, tv, **kw) \
        .to(tq.dtype).numpy()
    assert np.abs(before - want).max() > 1e-3


def test_prefill_attend_takes_attend_on_the_cpu():
    """A CPU tensor goes to the plain ``attend`` (no kernel route)."""
    _, _, _, tq, tk, tv = _inputs(1, 32, 4, 2, 64)
    n0 = dict(ops.LAUNCHES)
    got = attention.prefill_attend(tq, tk, tv)
    want = attention.attend(tq, tk, tv, causal=True)
    assert torch.equal(got, want)
    assert ops.LAUNCHES == n0


@pytest.mark.parametrize("Sq,Skv", [(40, 40), (8, 75)])
def test_non_causal_kernel_route_matches_the_reference(Sq, Skv):
    """Whisper's encoder self-attention (Sq = Skv) and cross-attention
    (Sq != Skv, ragged Skv) on the kernel route, ``causal=False``: the
    reference's flash function of ``qg`` within the fp32 summation order,
    its ``attend`` within p's bf16 rounding; on the CPU ``prefill_attend``
    is ``attend(causal=False)`` itself."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((1, Sq, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, Skv, 4, 64)).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16()
              for a in (k, v))
    got = attention.flash_prefill(tq, tk, tv, causal=False).numpy()
    qg = (jnp.asarray(q) * 64 ** -0.5).astype(jnp.bfloat16)
    want = np.asarray(jref.flash_attention(
        qg.astype(jnp.float32), jnp.asarray(k).astype(jnp.float32),
        jnp.asarray(v).astype(jnp.float32), causal=False, scale=1.0))
    assert np.abs(got - want).max() <= SUM_ORDER_TOL
    model = np.asarray(jattend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False))
    assert np.abs(got - model).max() <= P_ROUNDING_TOL
    plain = attention.prefill_attend(tq, tk, tv, causal=False)
    assert torch.equal(plain, attention.attend(tq, tk, tv, causal=False))
