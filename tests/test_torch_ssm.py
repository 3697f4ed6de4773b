"""The port's Mamba-2 SSD mixer against a naive recurrence and against the
JAX package.

A port of ``tests/test_ssm.py`` (chunked scan == naive recurrence ==
decode), then ``ssd_chunked``, ``ssd_decode``, ``causal_conv1d`` and
``mamba_mixer`` on the same numpy inputs through ``repro.models`` and
``repro_torch.models``: fp32 within 1e-5 (summation order differs), one
bf16 mixer within 2e-2 (both round to bf16 at the reference's casts; the
elementwise ops in between may round at other places), and the
intra-chunk decay at a dt whose exp overflows above the diagonal.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers, ssm

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _naive_ssd(xh, dt, A, Bm, Cm, Dp):
    B, S, H, hd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    state = np.zeros((B, H, hd, N), np.float64)
    ys = np.zeros((B, S, H, hd), np.float64)
    for t in range(S):
        dA = np.exp(dt[:, t] * A)                        # [B,H]
        Bh = np.repeat(Bm[:, t], R, axis=1)              # [B,H,N]
        Ch = np.repeat(Cm[:, t], R, axis=1)
        state = dA[:, :, None, None] * state \
            + dt[:, t][:, :, None, None] * xh[:, t][..., None] \
            * Bh[:, :, None, :]
        ys[:, t] = np.einsum("bhdn,bhn->bhd", state, Ch) \
            + Dp[None, :, None] * xh[:, t]
    return ys, state


def _inputs(B, S, H, hd, N, G, rng=RNG, dt_scale=0.1):
    xh = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = (rng.random((B, S, H)) * dt_scale + 0.01).astype(np.float32)
    A = -(rng.random(H) * 0.5 + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Dp = rng.random(H).astype(np.float32)
    return xh, dt, A, Bm, Cm, Dp


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("S,chunk,G", [(16, 4, 1), (24, 8, 2), (7, 16, 1)])
def test_chunked_matches_naive(S, chunk, G):
    arrays = _inputs(2, S, 4, 8, 8, G)
    y, state = ssm.ssd_chunked(*(_t(a) for a in arrays), chunk)
    yn, sn = _naive_ssd(*arrays)
    np.testing.assert_allclose(y.numpy(), yn, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), sn, rtol=1e-4, atol=1e-4)


def test_decode_continues_chunked():
    S = 12
    xh, dt, A, Bm, Cm, Dp = _inputs(1, S + 1, 2, 4, 4, 1)
    y_full, _ = ssm.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bm, Cm, Dp)),
                                4)
    _, state = ssm.ssd_chunked(_t(xh[:, :S]), _t(dt[:, :S]), _t(A),
                               _t(Bm[:, :S]), _t(Cm[:, :S]), _t(Dp), 4)
    y1, _ = ssm.ssd_decode(_t(xh[:, S]), _t(dt[:, S]), _t(A), _t(Bm[:, S]),
                           _t(Cm[:, S]), _t(Dp), state)
    np.testing.assert_allclose(y1.numpy(), y_full[:, S].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_intra_chunk_decay_stays_finite_where_exp_overflows():
    """dt * A of -40 a step: exp(cum_i - cum_j) above the diagonal is
    exp(+280) = inf in fp32; the mask selects 0 there, never inf * 0."""
    xh, dt, A, Bm, Cm, Dp = _inputs(1, 16, 2, 4, 4, 1, np.random.default_rng(3))
    dt = np.full_like(dt, 40.0)
    A = -np.ones_like(A)
    y, state = ssm.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bm, Cm, Dp)), 8)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    yn, sn = _naive_ssd(xh, dt, A, Bm, Cm, Dp)
    np.testing.assert_allclose(y.numpy(), yn, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ vs the JAX side
@pytest.mark.parametrize("S,chunk,G,state0", [(16, 4, 1, False),
                                              (21, 8, 2, False),
                                              (24, 8, 1, True),
                                              (5, 16, 1, True)])
def test_ssd_chunked_matches_jax(S, chunk, G, state0):
    rng = np.random.default_rng(S + chunk)
    arrays = _inputs(2, S, 4, 8, 8, G, rng)
    s0 = rng.standard_normal((2, 4, 8, 8)).astype(np.float32) \
        if state0 else None
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk,
                              None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_chunked(*(_t(a) for a in arrays), chunk,
                             None if s0 is None else _t(s0))
    assert ty.dtype == torch.float32 and tuple(ts.shape) == (2, 4, 8, 8)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), **TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_matches_jax(G):
    rng = np.random.default_rng(G)
    xh, dt, A, Bm, Cm, Dp = _inputs(3, 1, 4, 8, 8, G, rng)
    state = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    args = (xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], Dp, state)
    jy, js = jssm.ssd_decode(*(jnp.asarray(a) for a in args))
    ty, ts = ssm.ssd_decode(*(_t(a) for a in args))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), **TOL)


@pytest.mark.parametrize("S,with_state", [(9, False), (1, True), (6, True)])
def test_causal_conv1d_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    ty, tst = layers.causal_conv1d(_t(x), _t(w), _t(b),
                                   None if st is None else _t(st))
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())


def test_causal_conv1d_keeps_x_dtype():
    x = torch.randn(1, 5, 8, generator=torch.Generator().manual_seed(0))
    y, st = layers.causal_conv1d(x.bfloat16(), torch.randn(4, 8).bfloat16(),
                                 torch.zeros(8).bfloat16())
    assert y.dtype == st.dtype == torch.bfloat16
    assert tuple(st.shape) == (1, 3, 8)


SSM = dict(d_state=8, d_conv=4, expand=2, head_dim=8, n_groups=1, chunk=8)


def _mixer_params(d, rng, dtype=np.float32):
    s = SSMConfig(**SSM)
    din, H, conv_ch = ssm.ssm_dims(d, s)
    gn = s.n_groups * s.d_state
    p = {"in_proj": rng.standard_normal((d, 2 * din + 2 * gn + H)) * 0.1,
         "out_proj": rng.standard_normal((din, d)) * 0.1,
         "conv_w": rng.standard_normal((s.d_conv, conv_ch)) * 0.3,
         "conv_b": rng.standard_normal(conv_ch) * 0.1}
    p = {k: v.astype(dtype) for k, v in p.items()}
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    p.update(dt_bias=np.log(np.expm1(dt)).astype(np.float32),
             A_log=np.log(np.arange(1, H + 1, dtype=np.float32)),
             Dp=np.ones(H, np.float32),
             ssm_norm=(rng.standard_normal(din) * 0.1).astype(np.float32))
    return p


def _torch_tree(p, bf16=False):
    out = {}
    for k, v in p.items():
        t = torch.from_numpy(np.asarray(v, np.float32))
        out[k] = t.bfloat16() if bf16 and v.dtype == ml_dtypes.bfloat16 \
            else t
    return out


@pytest.mark.parametrize("S", [13, 16])
def test_mamba_mixer_prefill_then_decode_matches_jax(S):
    d = 16
    rng = np.random.default_rng(S)
    p = _mixer_params(d, rng)
    x = rng.standard_normal((2, S + 2, d)).astype(np.float32)
    js, ts = JSSMConfig(**SSM), SSMConfig(**SSM)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = _torch_tree(p)
    jy, (jc, jst) = jssm.mamba_mixer(jnp.asarray(x[:, :S]), jp, d, js)
    ty, (tc, tst) = ssm.mamba_mixer(_t(x[:, :S]), tp, d, ts)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jst), tst.numpy(), **TOL)
    for t in (S, S + 1):
        jy, (jc, jst) = jssm.mamba_mixer(jnp.asarray(x[:, t:t + 1]), jp, d,
                                         js, jc, jst, decode=True)
        ty, (tc, tst) = ssm.mamba_mixer(_t(x[:, t:t + 1]), tp, d, ts, tc,
                                        tst, decode=True)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
        np.testing.assert_allclose(np.asarray(jst), tst.numpy(), **TOL)


def test_mamba_mixer_bf16_matches_jax():
    """bf16 activations and matrices, fp32 dt_bias / A_log / Dp /
    ssm_norm (the reference's init types): the output and conv tail in
    bf16, the SSM state in fp32."""
    d, S = 16, 12
    rng = np.random.default_rng(7)
    p = _mixer_params(d, rng, dtype=ml_dtypes.bfloat16)
    x = rng.standard_normal((2, S, d)).astype(ml_dtypes.bfloat16)
    jy, (jc, jst) = jssm.mamba_mixer(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, d,
        JSSMConfig(**SSM))
    ty, (tc, tst) = ssm.mamba_mixer(_t(x.astype(np.float32)).bfloat16(),
                                    _torch_tree(p, bf16=True), d,
                                    SSMConfig(**SSM))
    assert ty.dtype == tc.dtype == torch.bfloat16
    assert tst.dtype == torch.float32
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(np.asarray(jy, np.float32), ty.float().numpy(),
                               rtol=2e-2, atol=2e-2 * scale)
    np.testing.assert_allclose(np.asarray(jst, np.float32), tst.numpy(),
                               rtol=2e-2, atol=2e-2)
