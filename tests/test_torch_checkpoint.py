"""The port's ``CheckpointManager`` against the JAX package's.

Ports of ``tests/test_checkpoint.py``'s five cases on torch trees, then
interop both ways: a checkpoint the reference wrote (bf16 leaves as raw
``|V2`` bytes, AdamW state with its int32 step) restores into the port
bit for bit, and one the port wrote restores into the reference bit for
bit, with the same file names, keys and dtypes on disk.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_path, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": torch.from_numpy(
                          rng.standard_normal((4, 4)).astype(np.float32)),
                      "b": torch.from_numpy(
                          rng.standard_normal(4).astype(np.float32))
                      .to(torch.bfloat16)},
            "step_scale": torch.tensor(1.5, dtype=torch.float32)}


def _jtree(seed=0):
    """The reference test's tree (the same values as :func:`_tree`)."""
    rng = np.random.default_rng(seed)
    return {"layer": {"w": jnp.asarray(rng.standard_normal((4, 4)),
                                       jnp.float32),
                      "b": jnp.asarray(rng.standard_normal(4),
                                       jnp.bfloat16)},
            "step_scale": jnp.asarray(1.5, jnp.float32)}


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 through an int16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    arr = np.asarray(x)
    return arr.view(np.int16) if arr.dtype == jnp.bfloat16 else arr


def _same_bits(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = list(leaves_with_path(ttree))
    assert len(jl) == len(tl)
    for (jp, a), (tp, b) in zip(jl, tl):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in jp)
        assert key == "/".join(map(str, tp))
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=key)


# ---------------------------------- ports of tests/test_checkpoint.py --
def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params = _tree(0)
    opt = {"m": _tree(1)}
    mgr.save(7, params, opt, extra={"loss": 1.25})
    p2, o2, manifest = mgr.restore(7, params, opt)
    for (_, a), (_, b) in zip(leaves_with_path((params, opt)),
                              leaves_with_path((p2, o2))):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert manifest["extra"]["loss"] == 1.25


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, params)
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]       # keep=2 garbage-collected


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params = _tree()
    mgr.save(5, params)
    # simulate a crash mid-save: directory without manifest
    os.makedirs(tmp_path / "step-9")
    np.savez(tmp_path / "step-9" / "params.npz", x=np.zeros(3))
    assert mgr.latest_step() == 5          # 9 has no manifest -> ignored


def test_restore_latest_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(_tree()) is None


def test_dtype_preserved(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params = _tree()
    mgr.save(1, params)
    p2, _, _ = mgr.restore(1, params)
    assert p2["layer"]["b"].dtype == torch.bfloat16


# ----------------------------------------------------------- interop --
def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jparams = _jtree(0)
    jopt = jadamw().init(jparams)
    jopt["m"] = _jtree(2)      # non-zero state, bf16 leaf included
    JCheckpointManager(str(tmp_path)).save(3, jparams, jopt,
                                           extra={"loss": 2.5})
    with np.load(tmp_path / "step-3" / "params.npz") as z:
        assert z["layer/b"].dtype == np.dtype("V2")
    params = _tree(5)
    like_opt = adamw().init(params)
    like_opt["m"] = _tree(5)
    step, p, o, manifest = CheckpointManager(str(tmp_path)).restore_latest(
        params, like_opt)
    assert step == 3 and manifest["extra"] == {"loss": 2.5}
    assert p["layer"]["b"].dtype == torch.bfloat16
    assert o["step"].dtype == torch.int32
    _same_bits(jparams, p)
    _same_bits(jopt, o)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    params = _tree(0)
    opt = adamw().init(params)
    opt["m"] = _tree(2)
    CheckpointManager(str(tmp_path)).save(4, params, opt,
                                          extra={"arch": "x"})
    d = tmp_path / "step-4"
    assert sorted(os.listdir(d)) == ["manifest.json", "opt_state.npz",
                                     "params.npz"]
    with open(d / "manifest.json") as f:
        assert json.load(f) == {"step": 4, "extra": {"arch": "x"},
                                "has_opt": True}
    with np.load(d / "params.npz") as z:
        assert sorted(z.files) == ["layer/b", "layer/w", "step_scale"]
        assert z["layer/b"].dtype == np.dtype("V2")
    jlike = _jtree(5)
    jlike_opt = jadamw().init(jlike)
    jlike_opt["m"] = _jtree(5)
    step, jp, jo, _ = JCheckpointManager(str(tmp_path)).restore_latest(
        jlike, jlike_opt)
    assert step == 4 and jp["layer"]["b"].dtype == jnp.bfloat16
    _same_bits(jp, params)
    _same_bits(jo, opt)


@pytest.mark.parametrize("layout", ["stacked", "per-layer"])
def test_list_groups_use_index_keys(tmp_path, layout):
    """A per-layer group (a list of dicts, as the served LM params hold
    them) is keyed by list index, as ``jax.tree_util`` names it."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    group = {"w": w} if layout == "stacked" else [{"w": w[0]}, {"w": w[1]}]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"blocks": group})
    with np.load(tmp_path / "step-1" / "params.npz") as z:
        keys = sorted(z.files)
    assert keys == (["blocks/w"] if layout == "stacked"
                    else ["blocks/0/w", "blocks/1/w"])
    like = {"blocks": tree_map(torch.zeros_like, group)}
    p, _, _ = mgr.restore(1, like)
    for (_, a), (_, b) in zip(leaves_with_path(p),
                              leaves_with_path({"blocks": group})):
        assert torch.equal(a, b)


def test_train_params_reads_every_bf16_form():
    """``convert.train_params`` takes a JAX bf16 export (ml_dtypes), raw
    ``|V2`` bytes (a loaded checkpoint) and ``uint16`` views alike, and
    types the leaves as the reference's init does: ``cfg.dtype`` for the
    matrices, fp32 for the norm scales; every leaf requires grad."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-7b"), dtype="bfloat16")
    w = jnp.asarray(np.random.default_rng(0).standard_normal((4, 6)),
                    jnp.bfloat16)
    bits = np.asarray(w).view(np.uint16)
    tree = {"a": {"wq": np.asarray(w)}, "b": {"wq": bits.view("V2")},
            "c": {"wq": bits}, "ln1": {"scale": np.asarray(w)}}
    out = convert.train_params(tree, cfg)
    for name in ("a", "b", "c"):
        t = out[name]["wq"]
        assert t.dtype == torch.bfloat16 and t.requires_grad
        np.testing.assert_array_equal(t.detach().view(torch.int16).numpy(),
                                      bits.view(np.int16))
    scale = out["ln1"]["scale"]
    assert scale.dtype == torch.float32 and scale.requires_grad
    np.testing.assert_array_equal(scale.detach().numpy(),
                                  np.asarray(w, np.float32))


def test_train_params_never_alias_the_numpy_tree():
    """On the CPU in the tree's own dtype the leaves are copies: training
    them (or the caller writing its arrays) leaves the other side alone."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-7b"), dtype="float32")
    tree = {"wq": np.ones((3, 3), np.float32),
            "ln1": {"scale": np.zeros(3, np.float32)}}
    out = convert.train_params(tree, cfg)
    tree["wq"][:] = 5.0
    tree["ln1"]["scale"][:] = 5.0
    assert bool((out["wq"] == 1.0).all())
    assert bool((out["ln1"]["scale"] == 0.0).all())
