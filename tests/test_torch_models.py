"""The port's dense transformer against the JAX package's.

The same weights — JAX's ``init`` exported to numpy and carried through
``repro_torch.convert.lm_tensors`` — and the same token ids (numpy, from
a seed) go through both model zoos: the layers, ``attend`` /
``decode_attend``, the forward, and ``prefill`` followed by three
``decode_step``s, over the reduced deepseek-7b (dense MHA), gemma2-9b
(sliding window, softcaps, tied and scaled embeddings, GeGLU),
qwen3-14b (qk-norm) and qwen2-72b (qkv bias).  Tolerance 1e-5 in fp32
(summation order differs; the observed gap is about 2e-7).  On the CPU
the port's prefill attention is the plain ``attend``; the
``flash_attention`` kernel is held against it on the card
(``tests/test_torch_cuda.py``).  The other families are
``tests/test_torch_families.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention, build, layers, transformer

torch.set_num_threads(2)

ARCHS = ["deepseek-7b", "gemma2-9b", "qwen3-14b", "qwen2-72b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(jax_out, port_out, **tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               port_out.float().numpy(), **(tol or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax api, jax params, port api, port params) of one reduced arch."""
    arch = request.param
    japi = jbuild(jreduced(jget_config(arch)))
    params = japi.init(jax.random.PRNGKey(0), 64)
    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    tapi = build(reduced(get_config(arch)))
    return japi, params, tapi, lm.rebuild(lm.tensors)


# ------------------------------------------------------------------ layers --
RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 5, 64)).astype(np.float32)
SCALE = (RNG.standard_normal(64) * 0.1).astype(np.float32)
BIAS = (RNG.standard_normal(64) * 0.1).astype(np.float32)
W1 = (RNG.standard_normal((64, 96)) * 0.1).astype(np.float32)
W2 = (RNG.standard_normal((96, 64)) * 0.1).astype(np.float32)
W3 = (RNG.standard_normal((64, 96)) * 0.1).astype(np.float32)
TABLE = RNG.standard_normal((50, 64)).astype(np.float32)
IDS = RNG.integers(0, 50, size=(2, 5)).astype(np.int32)
POS = np.arange(5, dtype=np.int32)[None, :] + 3
ROT = RNG.standard_normal((2, 5, 4, 16)).astype(np.float32)

LAYER_CASES = {
    "rms_norm": (lambda L, a: L.rms_norm(a(X), a(SCALE))),
    "layer_norm": (lambda L, a: L.layer_norm(a(X), a(SCALE), a(BIAS))),
    "softcap": (lambda L, a: L.softcap(a(X) * 40.0, 30.0)),
    "rotary": (lambda L, a: L.rotary(a(ROT), a(POS), 10_000.0)),
    "gelu": (lambda L, a: L.activation(a(X), "gelu")),
    "silu": (lambda L, a: L.activation(a(X), "silu")),
    "mlp_gated": (lambda L, a: L.mlp(a(X), {"w1": a(W1), "w2": a(W2),
                                            "w3": a(W3)}, "silu", True)),
    "mlp_plain": (lambda L, a: L.mlp(a(X), {"w1": a(W1), "w2": a(W2)},
                                     "gelu", False)),
    "unembed_tied_capped": (lambda L, a: L.unembed(a(X), a(TABLE), True,
                                                   30.0)),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name):
    fn = LAYER_CASES[name]
    _close(fn(jlayers, jnp.asarray), fn(layers, _t))


@pytest.mark.parametrize("scale", [False, True])
def test_embed_matches_jax(scale):
    want = jlayers.embed(jnp.asarray(IDS), jnp.asarray(TABLE), scale)
    got = layers.embed(torch.from_numpy(IDS), _t(TABLE), scale)
    _close(want, got, rtol=0, atol=0)


def test_bf16_embed_scale_stays_in_the_table_dtype():
    table = TABLE.astype(ml_dtypes.bfloat16)
    want = jlayers.embed(jnp.asarray(IDS), jnp.asarray(table), True)
    got = layers.embed(torch.from_numpy(IDS), _t(table).bfloat16(), True)
    assert got.dtype == torch.bfloat16
    _close(want, got, rtol=0, atol=0)


# --------------------------------------------------------------- attention --
ATTEND_CASES = [
    # B, Sq, Skv, H, K, hd, causal, window, cap, q_offset, kv_len, chunk
    (2, 16, 16, 4, 2, 16, True, 0, 0.0, 0, None, 8),
    (1, 24, 24, 4, 4, 8, True, 8, 30.0, 0, None, 16),     # ragged chunks
    (2, 8, 20, 2, 1, 16, False, 0, 0.0, 0, 13, 8),        # kv_len
    (1, 12, 12, 8, 2, 32, True, 0, 50.0, 0, None, 1024),  # one chunk
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap,qo,kvl,chunk",
                         ATTEND_CASES)
def test_attend_matches_jax(B, Sq, Skv, H, K, hd, causal, window, cap, qo,
                            kvl, chunk):
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
              kv_len=kvl, chunk=chunk)
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.attend(_t(q), _t(k), _t(v), **kw)
    _close(want, got)


@pytest.mark.parametrize("kv_len,window,cap", [(5, 0, 0.0), (11, 4, 50.0),
                                               (16, 0, 30.0)])
def test_decode_attend_matches_jax(kv_len, window, cap):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attend(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kv_len=jnp.asarray(kv_len),
                               window=window, softcap=cap)
    got = attention.decode_attend(_t(q), _t(k), _t(v), kv_len=kv_len,
                                  window=window, softcap=cap)
    _close(want, got)


def test_bf16_attend_keeps_the_reference_casts():
    """bf16 k/v: q scaled in fp32 then cast to bf16, p cast to bf16 before
    the product with v — the port's plain attend is the JAX model's."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 20, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 20, 2, 16)).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    want = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        chunk=8)
    got = attention.attend(_t(q), _t(k).bfloat16(), _t(v).bfloat16(),
                           chunk=8)
    _close(want, got, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model --
def test_lm_tensors_use_the_reference_cli_names(pair):
    japi, params, _, _ = pair
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    keys = ["/".join(str(getattr(p, "key", p)) for p in path)
            for path, _ in flat]
    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    assert list(lm.tensors) == keys
    for (path, leaf), key in zip(flat, keys):
        assert lm.shapes[key] == leaf.shape
        want = np.asarray(leaf, np.float32)
        if want.ndim > 2:
            want = want.reshape(want.shape[0], -1)
        np.testing.assert_array_equal(lm.tensors[key], want)


def test_forward_matches_jax(pair):
    japi, params, tapi, tparams = pair
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 20)).astype(
        np.int32)
    from repro.models import transformer as jtransformer
    want = jtransformer.forward(params, japi.cfg, jnp.asarray(toks))
    _close(want, tapi.forward(tparams, torch.from_numpy(toks)))


def test_prefill_and_decode_match_jax(pair):
    """Prompt of 24 tokens (past gemma2's reduced window of 16), then
    three decode steps fed the reference's greedy tokens."""
    japi, params, tapi, tparams = pair
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 24)).astype(
        np.int32)
    jl, jc = japi.prefill(params, {"tokens": jnp.asarray(toks)}, 28)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 28)
    assert tuple(tl.shape) == (2, 1, 256) and tc["pos"] == 24
    _close(jl, tl)
    np.testing.assert_allclose(np.asarray(jc["blocks"]["k"]),
                               tc["blocks"]["k"].numpy(), **TOL)
    for _ in range(3):
        nxt = np.asarray(jl.argmax(-1)).astype(np.int32)
        np.testing.assert_array_equal(nxt, tl.argmax(-1).numpy())
        jl, jc = japi.decode(params, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode(tparams, tc, torch.from_numpy(nxt))
        _close(jl, tl)
    assert tc["pos"] == 27


def test_per_layer_layout_serves_the_same_model():
    """The full-width layout (per-layer 2-D matrices) rebuilds params the
    transformer runs to the same logits as the stacked layout."""
    cfg = reduced(get_config("qwen2-72b"))
    params = transformer.init_params(cfg, seed=3)
    stacked = convert.lm_tensors(params, dtype=cfg.dtype)
    per_layer = convert.lm_tensors(params, dtype=cfg.dtype, per_layer=True)
    assert "blocks/1/attn/wq" in per_layer.tensors
    assert per_layer.tensors["blocks/1/attn/wq"].shape == (64, 64)
    assert stacked.tensors["blocks/attn/wq"].shape == (2, 64 * 64)
    toks = torch.from_numpy(np.arange(12, dtype=np.int32)[None] + 5)
    api = build(cfg)
    a = api.forward(stacked.rebuild(stacked.tensors), toks)
    b = api.forward(per_layer.rebuild(per_layer.tensors), toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_served_dtypes_follow_the_reference_init():
    """With a bf16 model dtype, matrices serve in bf16 and the norm
    leaves in fp32, as the reference's init types them."""
    cfg = reduced(get_config("qwen3-14b"))
    lm = convert.lm_tensors(transformer.init_params(cfg, 0),
                            dtype="bfloat16")
    for key in ("blocks/attn/wq", "blocks/mlp/w1", "embed", "head"):
        assert lm.dtypes[key] == torch.bfloat16
    for key in ("blocks/ln1/scale", "final_norm/scale", "blocks/attn/q_norm"):
        assert lm.dtypes[key] == torch.float32
    jparams = jbuild(jreduced(jget_config("qwen3-14b"))).init(
        jax.random.PRNGKey(0), 64)
    jdt = {"/".join(str(getattr(p, "key", p)) for p in path):
           str(leaf.dtype) for path, leaf in
           jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(jdt) == set(lm.dtypes)
