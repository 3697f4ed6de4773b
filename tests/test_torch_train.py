"""The port's training path against the JAX package's.

The reference's params (``init`` exported to numpy and carried through
``repro_torch.convert.train_params``) and the same batches (numpy, from a
seed) go through both packages:

  * ``loss`` and every gradient leaf of all ten reduced archs in fp32
    (loss within 1e-5; gradients rtol 1e-4 / atol 1e-6 of
    ``jax.value_and_grad(api.loss)``: summation order differs), and
    ``cfg.remat`` on against off (the same numbers);
  * ``LowPrecisionDot`` (the card's bf16 product) driven directly on the
    CPU: forward and VJP against ``jax.vjp`` of the reference's ``dot``
    (fp32 output 1e-6 relative, bf16 gradients equal or 1 ulp);
  * the slice as a whole: a run the reference trained 2 steps and
    checkpointed, resumed by each package to step 6 (losses within 1e-5
    at every step), with and without ``--compress-grads``;
  * the dedup-masked fine-tune (paper Sec. 4.3) on a store of two
    reduced deepseek variants: the same masks, three Adafactor steps in
    both packages (params 1e-6), masked elements unchanged bit for bit;
  * every kernel wrapper raises on an input that needs a gradient;
  * ports of ``tests/test_train_launch.py`` (its ``slow`` marks kept).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import main as jtrain_main
from repro.models import build as jbuild
from repro.models.layers import dot as jdot
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from repro_torch.core.finetune import gradient_masks
from repro_torch.data.pipeline import token_batches
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.launch.train import main as train_main
from repro_torch.models import build
from repro_torch.models.layers import LowPrecisionDot
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves_with_path, tree_map

torch.set_num_threads(2)

LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
FRAMES = 12


def _jkey(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jflat(tree):
    return {_jkey(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {"/".join(map(str, path)): leaf.detach().float().numpy()
            for path, leaf in leaves_with_path(tree)}


def _batch(cfg, B=2, S=20, seed=1):
    """tokens / labels (and the family's frames or image patches), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.vlm_stub:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _pair(arch):
    """(jax api, jax params, port api, port params to train)."""
    japi = jbuild(jreduced(jget_config(arch)))
    params = japi.init(jax.random.PRNGKey(0), 64)
    cfg = reduced(get_config(arch))
    tparams = convert.train_params(jax.tree_util.tree_map(np.asarray, params),
                                   cfg)
    return japi, params, build(cfg), tparams


def _port_loss_and_grads(api, tparams, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return value_and_grad(lambda p: api.loss(p, tb), tparams)


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_jax(arch):
    japi, params, tapi, tparams = _pair(arch)
    batch = _batch(japi.cfg)
    jl, jg = jax.value_and_grad(japi.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _port_loss_and_grads(tapi, tparams, batch)
    assert abs(float(jl) - float(tl)) <= LOSS_TOL
    want, got = _jflat(jg), _tflat(tg)
    assert sorted(want) == sorted(got)
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b",
                                  "kimi-k2-1t-a32b", "whisper-small"])
def test_remat_changes_no_value(arch):
    """``cfg.remat`` (each layer recomputed in the backward) gives the
    loss and gradients of the run that keeps its activations."""
    _, _, tapi, tparams = _pair(arch)
    batch = _batch(tapi.cfg)
    base = _port_loss_and_grads(tapi, tparams, batch)
    rapi = build(dataclasses.replace(tapi.cfg, remat=True))
    rem = _port_loss_and_grads(rapi, tparams, batch)
    assert float(rem[0]) == float(base[0])
    for (path, a), (_, b) in zip(leaves_with_path(base[1]),
                                 leaves_with_path(rem[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


@pytest.mark.parametrize("shape", [(24, 40, 56), (3, 128, 7)])
def test_low_precision_dot_matches_jax_vjp(shape):
    """The card's bf16 product, driven on the CPU: fp32 output, and the
    reference's VJP: each operand's gradient the fp32 cotangent times the
    other operand widened, rounded once to bf16."""
    M, K, N = shape
    rng = np.random.default_rng(3)
    a32 = rng.standard_normal((M, K)).astype(np.float32)
    b32 = rng.standard_normal((K, N)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    ja, jb = jnp.asarray(a32, jnp.bfloat16), jnp.asarray(b32, jnp.bfloat16)
    jout, vjp = jax.vjp(jdot, ja, jb)
    jga, jgb = vjp(jnp.asarray(g))
    a = torch.from_numpy(a32).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(b32).to(torch.bfloat16).requires_grad_()
    out = LowPrecisionDot.apply(a, b)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    for got, want in ((a.grad, jga), (b.grad, jgb)):
        want = torch.from_numpy(np.asarray(want, np.float32))
        ulp = torch.abs(want) * 2.0 ** -7 + 1e-30
        assert bool((torch.abs(got.float() - want) <= ulp).all())
        assert float((got.float() == want).float().mean()) > 0.99


# ------------------------------------------------------ kernel guards --
def _guard_calls():
    """One call a wrapper, on inputs that need a gradient."""
    g = torch.Generator().manual_seed(0)
    pool = torch.randn(4, 8, 8, generator=g, requires_grad=True)
    bmap = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    q = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16, generator=g)
    blocks = torch.randn(5, 16, generator=g, requires_grad=True)
    return {
        "dedup_matmul": lambda: ops.dedup_matmul(
            torch.randn(3, 16, generator=g), pool, bmap),
        "dedup_embedding": lambda: ops.dedup_embedding(
            torch.tensor([0, 9], dtype=torch.int32), pool,
            torch.tensor([0, 1, 2, 3], dtype=torch.int32)),
        "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        "lsh_signature": lambda: ops.lsh_signature(
            blocks, torch.randn(16, 4, generator=g), torch.zeros(4), 1.0),
        "split_bf16x3": lambda: ops.split_bf16x3(blocks),
    }


@pytest.mark.parametrize("name", sorted(ops.LAUNCHES))
def test_kernel_wrappers_refuse_inputs_that_need_grad(name):
    """A kernel writes through raw pointers and has no backward: on an
    input that needs a gradient the wrapper raises (before the CPU / CUDA
    split, so the CPU reaches it) instead of dropping the gradient; under
    ``torch.no_grad()`` it runs."""
    call = _guard_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        out = call()
    assert out.grad_fn is None


def test_loss_never_reaches_the_kernel_route():
    """``loss`` runs the plain attention whatever ``attention=`` says, so
    it has gradients with the kernel route asked for (on the CPU the
    prefill route is the plain version too; the card test holds it)."""
    _, _, tapi, tparams = _pair("deepseek-7b")
    batch = _batch(tapi.cfg)
    plain = build(tapi.cfg, attention="plain")
    a = _port_loss_and_grads(tapi, tparams, batch)
    b = _port_loss_and_grads(plain, tparams, batch)
    assert float(a[0]) == float(b[0])


# --------------------------------------------------- the whole slice --
TRAIN = ["--arch", "deepseek-7b", "--reduced", "--batch", "4", "--seq",
         "16", "--seed", "3"]


@pytest.mark.parametrize("compress", [False, True])
def test_resume_of_a_reference_checkpoint_matches(tmp_path, compress):
    """The reference trains 2 steps and checkpoints (params + AdamW state);
    each package resumes a copy to step 6: the same losses at steps 2-5."""
    extra = ["--compress-grads"] if compress else []
    d = tmp_path / "ck"
    jtrain_main(TRAIN + ["--steps", "2", "--ckpt", str(d)])
    shutil.copytree(d, tmp_path / "ref")
    shutil.copytree(d, tmp_path / "port")
    want = jtrain_main(TRAIN + extra + ["--steps", "6", "--resume", "auto",
                                        "--ckpt", str(tmp_path / "ref")])
    got = train_main(TRAIN + extra + ["--steps", "6", "--resume", "auto",
                                      "--ckpt", str(tmp_path / "port"),
                                      "--device", "cpu"])
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_TOL)


def test_train_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(TRAIN + ["--steps", "1"])


# ------------------------------------------------- masked fine-tune --
def _variants(cfg):
    """Two variants of a reduced deepseek: v1 = v0 with the last layer's
    feed-forward weights drawn again (a fine-tuned layer)."""
    from repro_torch.models.transformer import init_params
    v0 = init_params(cfg, 0)
    v1 = tree_map(np.copy, v0)
    rng = np.random.default_rng(1)
    for name in ("w1", "w2", "w3"):
        w = v1["blocks"]["mlp"][name]
        w[-1] = rng.standard_normal(w.shape[1:]).astype(np.float32) * 0.02
    return v0, v1


def test_masked_finetune_matches_jax_and_freezes_shared_blocks():
    """Paper Sec. 4.3: v1's gradient masks (1 on blocks private to v1)
    from the store, mapped onto v1's params through ``lm_tensors``'
    ``rebuild``; three Adafactor steps (weight decay 0, so a zero
    gradient makes a zero update) in both packages with the same masks:
    losses 1e-5, params 1e-6, and every masked element of the port's
    params equal to the store's bit for bit."""
    cfg = reduced(get_config("deepseek-7b"))
    v0, v1 = _variants(cfg)
    lm1 = convert.lm_tensors(v1)
    store = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(16, 16), lsh=LSHConfig(r=0.25),
                          validate=False), blocks_per_page=4))
    store.register("v0", convert.lm_tensors(v0).tensors)
    store.register("v1", lm1.tensors)
    masks = gradient_masks(store.dedup, "v1")
    dense = {n: store.materialize("v1", n) for n in lm1.tensors}
    frozen = {n: m == 0 for n, m in masks.items()}
    n_frozen = sum(int(f.sum()) for f in frozen.values())
    assert 0 < n_frozen < sum(f.size for f in frozen.values())

    mask_tree = lm1.rebuild(masks)
    params = convert.train_params(lm1.rebuild(dense), cfg)
    opt = make_optimizer("adafactor")
    step = make_train_step(
        build(cfg), opt,
        grad_transform=lambda g: tree_map(torch.mul, g, mask_tree))
    jmasks = tree_map(lambda t: jnp.asarray(t.numpy()), mask_tree)
    jparams = tree_map(lambda t: jnp.asarray(t.numpy()), lm1.rebuild(dense))
    jopt = jmake_optimizer("adafactor")
    jstep = jmake_train_step(
        jbuild(jreduced(jget_config("deepseek-7b"))), jopt,
        grad_transform=lambda g: jax.tree.map(jnp.multiply, g, jmasks))
    state, jstate = opt.init(params), jopt.init(jparams)
    data = token_batches(cfg.vocab, 2, 16, seed=4)
    for _ in range(3):
        b = next(data)
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
    got, want = _tflat(params), _jflat(jparams)
    for key, arr in got.items():
        np.testing.assert_allclose(arr, want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    changed = 0
    for n, fz in frozen.items():
        tuned = got[n].reshape(dense[n].shape)
        assert np.array_equal(tuned[fz], dense[n][fz]), n
        changed += int((tuned != dense[n]).sum())
    assert changed > 0


# ---------------------------------- ports of tests/test_train_launch.py --
@pytest.mark.slow
def test_loss_decreases_tiny_lm():
    # uniform-random token streams sit at the entropy floor (ln V), so the
    # optimizer smoke test overfits a fixed batch instead
    out = train_main(["--arch", "deepseek-7b", "--reduced", "--steps", "30",
                      "--batch", "8", "--seq", "32", "--lr", "3e-3",
                      "--seed", "1", "--overfit", "--device", "cpu"])
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5


@pytest.mark.slow
def test_resume_continues(tmp_path):
    ck = str(tmp_path / "ck")
    train_main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "6",
                "--batch", "4", "--seq", "16", "--ckpt", ck,
                "--ckpt-every", "3", "--device", "cpu"])
    out = train_main(["--arch", "mamba2-1.3b", "--reduced", "--steps", "9",
                      "--batch", "4", "--seq", "16", "--ckpt", ck,
                      "--resume", "auto", "--device", "cpu"])
    assert len(out["losses"]) == 3          # resumed at 6, ran 6..8


@pytest.mark.slow
def test_compressed_grads_track_uncompressed():
    a = train_main(["--arch", "deepseek-7b", "--reduced", "--steps", "10",
                    "--batch", "4", "--seq", "16", "--seed", "2",
                    "--device", "cpu"])
    b = train_main(["--arch", "deepseek-7b", "--reduced", "--steps", "10",
                    "--batch", "4", "--seq", "16", "--seed", "2",
                    "--compress-grads", "--device", "cpu"])
    # int8+EF stays close to the fp32 trajectory
    assert abs(a["losses"][-1] - b["losses"][-1]) < 0.25


def test_data_shards_partition_batch():
    """Disjoint, deterministic streams per host (elastic re-mesh safety),
    from the port's copy of the data pipeline."""
    h0 = next(token_batches(97, 8, 16, seed=3, host_index=0, host_count=2))
    h1 = next(token_batches(97, 8, 16, seed=3, host_index=1, host_count=2))
    assert h0["tokens"].shape == (4, 16)
    assert h1["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    h0b = next(token_batches(97, 8, 16, seed=3, host_index=0, host_count=2))
    assert np.array_equal(h0["tokens"], h0b["tokens"])
