"""The port's other model families against the JAX package's.

The same weights — JAX's ``init`` exported to numpy and carried through
``repro_torch.convert.lm_tensors`` — and the same inputs (numpy, from a
seed) go through both model zoos for the reduced hymba-1.5b (hybrid:
attention + mamba, sliding window with global first / middle / last
layers), mamba2-1.3b (SSM), kimi-k2 (a dense first layer, then MoE),
arctic-480b (MoE with a parallel dense FFN), phi-3-vision (the VLM stub,
``image_embeds``) and whisper-small (encoder-decoder, ``frames``): the
forward, and prefill followed by three decode steps fed the reference's
greedy tokens, within 1e-5 in fp32 (summation order differs).  Then the
carried names and served dtypes, the per-layer layout of every layer
group, the reference's layer groups and windows, and ports of
``tests/test_models_smoke.py``'s prefill / decode shape and
decode-matches-forward tests (the train step waits for training).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build, encdec, transformer

torch.set_num_threads(2)

FAMILIES = ["hymba-1.5b", "mamba2-1.3b", "kimi-k2-1t-a32b", "arctic-480b",
            "phi-3-vision-4.2b", "whisper-small"]
TOL = dict(rtol=1e-5, atol=1e-5)
FRAMES = 12


def _close(jax_out, port_out, **tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               port_out.float().numpy(), **(tol or TOL))


def _keys(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


def _extras(cfg, B, seed=5):
    """The family's non-token inputs, numpy: frames or image patches."""
    rng = np.random.default_rng(seed)
    if cfg.encdec:
        return {"frames": rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)}
    if cfg.vlm_stub:
        return {"image_embeds": rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    return {}


def _port_init(cfg, seed=0):
    return encdec.init_params(cfg, seed, max_dec=64) if cfg.encdec \
        else transformer.init_params(cfg, seed)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(jax api, jax params, port api, port params) of one reduced arch."""
    arch = request.param
    japi = jbuild(jreduced(jget_config(arch)))
    params = japi.init(jax.random.PRNGKey(0), 64)
    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    tapi = build(reduced(get_config(arch)))
    return japi, params, tapi, lm.rebuild(lm.tensors)


def test_forward_matches_jax(pair):
    japi, params, tapi, tparams = pair
    cfg = japi.cfg
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 20)).astype(
        np.int32)
    ex = _extras(cfg, 2)
    if cfg.encdec:
        jf = jnp.asarray(ex["frames"])
        want = jencdec.decode_train(params, cfg, jnp.asarray(toks),
                                    jencdec.encode(params, cfg, jf))
        got = tapi.forward(tparams, torch.from_numpy(toks),
                           torch.from_numpy(ex["frames"]))
    else:
        img = ex.get("image_embeds")
        want = jtransformer.forward(params, cfg, jnp.asarray(toks),
                                    None if img is None else jnp.asarray(img))
        got = tapi.forward(tparams, torch.from_numpy(toks),
                           None if img is None else torch.from_numpy(img))
    assert tuple(got.shape) == tuple(want.shape)
    _close(want, got)


def test_prefill_and_decode_match_jax(pair):
    """A prompt of 24 tokens (past hymba's reduced window of 16 and three
    SSD chunks of 8), then three decode steps fed the reference's greedy
    tokens; the caches (k / v, conv and SSM states) agree too."""
    japi, params, tapi, tparams = pair
    cfg = japi.cfg
    toks = np.random.default_rng(1).integers(1, 256, size=(2, 24)).astype(
        np.int32)
    batch = {"tokens": toks, **_extras(cfg, 2)}
    max_len = 28 + (cfg.num_patches if cfg.vlm_stub else 0)
    jl, jc = japi.prefill(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, max_len)
    tl, tc = tapi.prefill(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, max_len)
    assert tuple(tl.shape) == (2, 1, 256)
    assert tc["pos"] == int(jc["pos"])
    _close(jl, tl)
    for key in ("k", "conv_state", "ssm_state", "enc_k"):
        for name in ("blocks", "dense_blocks", None):
            jg, tg = (jc, tc) if name is None else (jc.get(name),
                                                    tc.get(name))
            if jg is not None and key in jg:
                _close(jg[key], tg[key])
    for _ in range(3):
        nxt = np.asarray(jl.argmax(-1)).astype(np.int32)
        np.testing.assert_array_equal(nxt, tl.argmax(-1).numpy())
        jl, jc = japi.decode(params, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode(tparams, tc, torch.from_numpy(nxt))
        _close(jl, tl)
    assert tc["pos"] == int(jc["pos"])


def test_lm_tensors_names_and_served_dtypes(pair):
    """The carried keys are the reference CLI's; with a bf16 model the
    port's own init serves every leaf in the dtype the reference's bf16
    init gives it (the router, dt_bias, A_log, Dp, ssm_norm and the norms
    in fp32)."""
    japi, params, _, _ = pair
    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    want = _keys(params)
    assert list(lm.tensors) == list(want)
    for key, leaf in want.items():
        assert lm.shapes[key] == leaf.shape
    cfg16 = dataclasses.replace(japi.cfg, dtype="bfloat16")
    jdt = {k: str(v.dtype) for k, v in _keys(
        jbuild(cfg16).init(jax.random.PRNGKey(0), 64)).items()}
    port = convert.lm_tensors(_port_init(japi.cfg), dtype="bfloat16")
    assert set(port.dtypes) == set(jdt)
    for key, dt in jdt.items():
        assert str(port.dtypes[key]).replace("torch.", "") == dt, key


def test_per_layer_groups_serve_the_same_model(pair):
    """Every stacked group (blocks, dense_blocks, enc_blocks, dec_blocks)
    splits into per-layer matrices and rebuilds to a per-layer list that
    runs to the same logits as the stacked layout."""
    japi, params, tapi, _ = pair
    cfg = japi.cfg
    tree = _port_init(cfg, seed=3)
    stacked = convert.lm_tensors(tree, dtype=cfg.dtype)
    per_layer = convert.lm_tensors(tree, dtype=cfg.dtype, per_layer=True)
    groups = [g for g in convert.LAYERS if g in tree]
    assert groups
    for g in groups:
        assert not any(k.startswith(g + "/") and not k.split("/")[1].isdigit()
                       for k in per_layer.tensors)
        assert isinstance(per_layer.rebuild(per_layer.tensors)[g], list)
    toks = torch.from_numpy(np.arange(12, dtype=np.int32)[None] + 5)
    ex = {k: torch.from_numpy(v) for k, v in _extras(cfg, 1).items()}
    a = tapi.forward(stacked.rebuild(stacked.tensors), toks, *ex.values())
    b = tapi.forward(per_layer.rebuild(per_layer.tensors), toks,
                     *ex.values())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------------------------- groups --
@pytest.mark.parametrize("arch", list_archs())
def test_groups_and_windows_match_the_reference(arch):
    """The reference's groups, kinds, depths and per-layer windows, at
    full size and reduced; the port's init has the reference's tree and
    shapes."""
    for jcfg, cfg in ((jget_config(arch), get_config(arch)),
                      (jreduced(jget_config(arch)), reduced(get_config(arch)))):
        if cfg.encdec:
            continue
        want = [(g.name, g.kind, g.n, tuple(g.windows))
                for g in jtransformer.build_groups(jcfg)]
        got = [(g.name, g.kind, g.n, g.windows)
               for g in transformer.build_groups(cfg)]
        assert got == want
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jshapes = {k: v.shape for k, v in _keys(
        jbuild(jcfg).init(jax.random.PRNGKey(0), 64)).items()}
    tshapes = {k: v.shape for k, v in _keys(_port_init(cfg)).items()}
    assert tshapes == jshapes


def test_hymba_windows_are_global_at_first_middle_and_last():
    cfg = get_config("hymba-1.5b")
    (g,) = transformer.build_groups(cfg)
    assert g.kind == "hybrid" and g.n == 32
    assert [i for i, w in enumerate(g.windows) if w == 0] == [0, 16, 31]
    assert all(w == 1024 for i, w in enumerate(g.windows)
               if i not in (0, 16, 31))
    cut = dataclasses.replace(cfg, num_layers=4)     # chip_smoke's depth
    assert transformer.build_groups(cut)[0].windows == (0, 1024, 0, 0)


def test_mamba_init_follows_the_reference():
    cfg = reduced(get_config("hymba-1.5b"))
    m = transformer.init_params(cfg, 0)["blocks"]["mamba"]
    dt = np.log1p(np.exp(m["dt_bias"]))                  # softplus
    assert (dt > 1e-3 * 0.999).all() and (dt < 1e-1 * 1.001).all()
    H = m["A_log"].shape[1]
    np.testing.assert_allclose(np.exp(m["A_log"][0]), np.arange(1, H + 1),
                               rtol=1e-6)
    assert (m["Dp"] == 1).all() and (m["ssm_norm"] == 0).all()
    assert (m["conv_b"] == 0).all()


# ------------------------------------- ports of tests/test_models_smoke.py --
@pytest.mark.parametrize("arch", list_archs())
def test_prefill_decode_shapes(arch):
    cfg = reduced(get_config(arch))
    api = build(cfg)
    lm = convert.lm_tensors(_port_init(cfg))
    params = lm.rebuild(lm.tensors)
    B, S = 2, 16
    if cfg.encdec:
        batch = {"frames": torch.ones((B, S, cfg.d_model)),
                 "tokens": torch.ones((B, 8), dtype=torch.int32)}
    elif cfg.vlm_stub:
        batch = {"tokens": torch.ones((B, S), dtype=torch.int32),
                 "image_embeds": torch.ones((B, cfg.num_patches,
                                             cfg.d_model))}
    else:
        batch = {"tokens": torch.ones((B, S), dtype=torch.int32)}
    logits, cache = api.prefill(params, batch, 32)
    pos = cache["pos"]
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    lg2, cache2 = api.decode(params, cache, torch.ones((B, 1),
                                                       dtype=torch.int32))
    assert tuple(lg2.shape) == (B, 1, cfg.vocab)
    assert torch.isfinite(lg2).all(), f"{arch}: NaN decode logits"
    assert cache2["pos"] == pos + 1


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-9b", "hymba-1.5b",
                                  "mamba2-1.3b", "kimi-k2-1t-a32b",
                                  "whisper-small", "phi-3-vision-4.2b"])
def test_decode_matches_forward(arch):
    """KV / SSM cache correctness: prefill + decode == the full forward."""
    cfg = reduced(get_config(arch))
    api = build(cfg)
    lm = convert.lm_tensors(_port_init(cfg, seed=1))
    params = lm.rebuild(lm.tensors)
    B, S = 2, 13
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    if cfg.encdec:
        frames = torch.from_numpy(rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32))
        full = api.forward(params, toks, frames)
        _, cache = api.prefill(params, {"frames": frames,
                                        "tokens": toks[:, :S]}, 32)
        ref = full[:, S]
    elif cfg.vlm_stub:
        img = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
        full = api.forward(params, toks, img)
        _, cache = api.prefill(params, {"tokens": toks[:, :S],
                                        "image_embeds": img},
                               cfg.num_patches + S + 4)
        ref = full[:, cfg.num_patches + S]
    else:
        full = api.forward(params, toks)
        _, cache = api.prefill(params, {"tokens": toks[:, :S]}, S + 4)
        ref = full[:, S]
    lg, _ = api.decode(params, cache, toks[:, S:S + 1])
    err = float((lg[:, 0] - ref).abs().max())
    assert err < 2e-3, f"{arch}: decode/forward divergence {err}"
