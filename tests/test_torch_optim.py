"""The port's optimizers and gradient compression against the JAX
package's.

From identical grads, state and params (numpy, from a seed): four AdamW
and Adafactor updates under a warmup-cosine schedule with global-norm
clipping give the reference's params and state (fp32 within 1e-6
absolute and relative: the reductions sum in another order; bf16 params
equal or 1 ulp), and ``compress_with_feedback`` gives its int8 payload,
dequantized grads and error state exactly (both round half to even).
Then ports of ``tests/test_optim.py`` (its ``state_specs`` case comes
with the sharding slice) and ``tests/test_compression.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import \
    compress_with_feedback as jcompress_with_feedback
from repro.distributed.compression import quantize_leaf as jquantize_leaf
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine_schedule
from repro_torch.convert import to_tensor
from repro_torch.distributed.compression import (compress_with_feedback,
                                                 dequantize_leaf,
                                                 init_error_state,
                                                 make_grad_compressor,
                                                 quantize_leaf)
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               cosine_schedule, make_optimizer)
from repro_torch.tree import leaves_with_path, tree_map

F32_TOL = dict(rtol=1e-6, atol=1e-6)
OPTIMIZERS = {"adamw": (adamw, jadamw), "adafactor": (adafactor, jadafactor)}


def _tree(rng, scale=1.0):
    """A stacked matrix, a vector and a plain matrix (factored and not)."""
    return {"layer": {"w": rng.standard_normal((3, 8, 16)) * 0.1 * scale,
                      "b": rng.standard_normal(16) * scale},
            "embed": rng.standard_normal((32, 8)) * scale}


def _as_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32).astype(dtype),
                        tree)


def _as_port(jtree):
    """The same values (bf16 bits included) as torch tensors."""
    def leaf(x):
        arr = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return to_tensor(arr.view(np.uint16))
        return torch.from_numpy(np.array(arr))
    return jax.tree.map(leaf, jtree)


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"/".join(map(str, path)): leaf.float().numpy()
            for path, leaf in leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_matches_jax(name, dtype):
    make, jmake = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    jparams = _as_jax(_tree(rng), dtype)
    jgrads = [_as_jax(_tree(rng, 10.0), dtype) for _ in range(4)]
    params = _as_port(jparams)
    jopt = jmake(lr=1e-2, schedule=jcosine_schedule(1e-2, warmup=2,
                                                    total=10))
    opt = make(lr=1e-2, schedule=cosine_schedule(1e-2, warmup=2, total=10))
    jstate, state = jopt.init(jparams), opt.init(params)
    for jg in jgrads:
        jparams, jstate, jnorm = jopt.update(jg, jstate, jparams)
        params, state, norm = opt.update(_as_port(jg), state, params)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 4
    assert state["step"].dtype == torch.int32
    want, got = _flat_jax(jstate), _flat_port(state)
    assert sorted(want) == sorted(got)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **F32_TOL)
    want, got = _flat_jax(jparams), _flat_port(params)
    for key in got:
        if dtype == "float32":
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **F32_TOL)
        else:        # bf16: equal or one unit in the last place
            np.testing.assert_array_less(np.abs(got[key] - want[key]),
                                         np.abs(want[key]) * 2.0 ** -7
                                         + 1e-30, err_msg=key)
    for _, p in leaves_with_path(params):
        assert p.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_keeps_requires_grad_and_inputs(name):
    """Functional: new params that require grad as the old ones did, the
    old params and state untouched."""
    params = {"w": torch.ones(4, 4, requires_grad=True),
              "b": torch.zeros(4)}
    opt = make_optimizer(name, lr=0.1)
    state = opt.init(params)
    grads = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    new, new_state, _ = opt.update(grads, state, params)
    assert new["w"].requires_grad and not new["b"].requires_grad
    assert new["w"].grad_fn is None
    assert bool((params["w"] == 1).all()) and int(state["step"]) == 0
    assert int(new_state["step"]) == 1


def test_compression_matches_jax_exactly():
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    err = _tree(rng, 0.01)
    jd, je = jcompress_with_feedback(_as_jax(grads, jnp.float32),
                                     _as_jax(err, jnp.float32))
    td, te = compress_with_feedback(_as_port(_as_jax(grads, jnp.float32)),
                                    _as_port(_as_jax(err, jnp.float32)))
    for want, got in ((_flat_jax(jd), _flat_port(td)),
                      (_flat_jax(je), _flat_port(te))):
        assert sorted(want) == sorted(got)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the int8 payload, half-way values included (round half to even)
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.25], np.float32)
    jq, js = jquantize_leaf(jnp.asarray(g))
    q, s = quantize_leaf(torch.from_numpy(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_grad_compressor_transform():
    grads = {"w": torch.tensor([0.003, -1.0, 0.49])}
    err = init_error_state(grads)
    deq, err2 = make_grad_compressor()((grads, err))
    want = compress_with_feedback(grads, err)
    assert torch.equal(deq["w"], want[0]["w"])
    assert torch.equal(err2["w"], want[1]["w"])


# ---------------------------------------- ports of tests/test_optim.py --
def _quadratic_losses(opt, steps=60):
    target = torch.from_numpy(np.random.default_rng(0)
                              .standard_normal((8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), requires_grad=True),
              "b": torch.zeros((8,), requires_grad=True)}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        loss = torch.mean((params["w"] - target) ** 2) \
            + torch.mean(params["b"] ** 2)
        gw, gb = torch.autograd.grad(loss, [params["w"], params["b"]])
        params, state, _ = opt.update({"w": gw, "b": gb}, state, params)
        losses.append(float(loss.detach()))
    return losses


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_converge(name):
    opt = make_optimizer(name, lr=5e-2)
    losses = _quadratic_losses(opt)
    assert losses[-1] < losses[0] * 0.2


def test_grad_clip():
    grads = {"a": torch.ones((10,)) * 100.0}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(100.0 * np.sqrt(10), rel=1e-5)
    cn = torch.sqrt(torch.sum(clipped["a"] ** 2))
    assert float(cn) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    s = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(s(torch.tensor(0))) == 0.0
    assert float(s(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(s(torch.tensor(100))) < 2e-4


def test_adafactor_memory_smaller_than_adam():
    params = {"w": torch.zeros((256, 256))}
    a = adamw().init(params)
    f = adafactor().init(params)
    bytes_a = sum(leaf.numel() * 4 for _, leaf in leaves_with_path(a["m"]))
    bytes_f = sum(leaf.numel() * 4 for _, leaf in leaves_with_path(f["v"]))
    assert bytes_f < bytes_a / 10


# ---------------------------------- ports of tests/test_compression.py --
def test_quantize_roundtrip_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    q, s = quantize_leaf(g)
    deq = dequantize_leaf(q, s)
    assert q.dtype == torch.int8
    assert float(torch.abs(deq - g).max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_unbiased_over_time():
    """With a constant gradient, EF-compressed updates average to the true
    gradient (error does not accumulate unboundedly)."""
    g = {"w": torch.tensor([0.003, -1.0, 0.49])}
    err = init_error_state(g)
    total = torch.zeros(3)
    n = 50
    for _ in range(n):
        deq, err = compress_with_feedback(g, err)
        total = total + deq["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               atol=1e-3)


def test_compressed_training_converges():
    target = torch.from_numpy(np.random.default_rng(1)
                              .standard_normal((6, 6)).astype(np.float32))
    params = {"w": torch.zeros((6, 6), requires_grad=True)}
    opt = adamw(lr=5e-2)
    state = opt.init(params)
    err = init_error_state(params)
    losses = []
    for _ in range(80):
        loss = torch.mean((params["w"] - target) ** 2)
        (gw,) = torch.autograd.grad(loss, [params["w"]])
        grads, err = compress_with_feedback({"w": gw}, err)
        params, state, _ = opt.update(grads, state, params)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.1


def test_tree_map_walks_in_leaf_order():
    """The trees the optimizers walk: dict keys sorted, lists in order,
    as ``jax.tree_util`` flattens them."""
    tree = {"b": [1, 2], "a": {"z": 3, "y": 4}}
    assert [p for p, _ in leaves_with_path(tree)] == [
        ("a", "y"), ("a", "z"), ("b", 0), ("b", 1)]
    seen = []
    tree_map(seen.append, tree)
    assert seen == [4, 3, 1, 2]
    assert jax.tree.leaves(tree) == seen
