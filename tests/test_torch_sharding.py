"""The port's sharding recipes against the JAX package's.

Ports of ``tests/test_sharding.py``; then every param leaf's spec (and
its sanitized form on both production meshes), the decode caches' and
the optimizers' state specs, for all ten archs and the three modes,
equal to the reference's entry by entry (the reference's params from
``jax.eval_shape``, no devices); the DTensor local shard of every spec
the shape the spec implies, on an 8-rank fake mesh (in a subprocess:
a process holds one process group); ``hint`` and ``reshape`` on
DTensors; and the stacked slab laid out over the serving mesh.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.distributed.sharding import (P, _fit_rank, cache_specs,
                                              make_recipe, param_spec,
                                              param_specs, sanitize_spec,
                                              use_recipe)
from repro_torch.models.registry import input_specs, param_shapes
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves_with_path

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
MODES = ("train", "prefill", "decode")
MODE_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}


# ------------------------------------------- ports of test_sharding.py --
def test_param_rules():
    rec = make_recipe("train")
    assert param_spec("blocks/attn/wq", 3, rec) == P(None, "data", "model")
    assert param_spec("blocks/attn/wo", 3, rec) == P(None, "model", "data")
    assert param_spec("blocks/mlp/w2", 3, rec) == P(None, "model", "data")
    assert param_spec("blocks/moe/ew1", 4, rec) == P(None, "model", "data",
                                                     None)
    assert param_spec("embed", 2, rec) == P("model", "data")
    assert param_spec("blocks/ln1/scale", 2, rec) == P()
    assert param_spec("blocks/mamba/in_proj", 3, rec) == \
        P(None, "data", "model")
    assert param_spec("dec_blocks/cross/cq", 3, rec) == \
        P(None, "data", "model")


def test_param_specs_tree_structure():
    params = {"embed": np.zeros((16, 8)),
              "blocks": {"attn": {"wq": np.zeros((2, 8, 8))},
                         "ln1": {"scale": np.zeros((2, 8))}}}
    specs = param_specs(params, make_recipe("train"))
    assert specs["embed"] == P("model", "data")
    assert specs["blocks"]["attn"]["wq"] == P(None, "data", "model")


class _FakeMesh:
    shape = {"data": 4, "model": 2, "pod": 2}


def test_sanitize_spec_drops_nondivisible():
    mesh = _FakeMesh()
    assert sanitize_spec(P("data", None), (8, 3), mesh) == P("data", None)
    assert sanitize_spec(P("data", None), (6, 3), mesh) == P(None, None)
    assert sanitize_spec(P(("pod", "data"), None), (8, 3), mesh) == \
        P(("pod", "data"), None)
    # 4 % (2*4) != 0 but 4 % 2 == 0 -> keep only the leading axis
    assert sanitize_spec(P(("pod", "data"),), (4,), mesh) == P("pod")


def test_fit_rank():
    assert _fit_rank(P("data", None, "model"), 2) == P("data", "model")
    assert _fit_rank(P("data",), 3) == P("data", None, None)


def test_hint_identity_without_recipe():
    from repro_torch.distributed.sharding import hint
    x = torch.ones((4, 4))
    assert hint(x, "residual") is x
    with use_recipe(make_recipe("train")):      # a plain tensor: identity
        assert hint(x, "residual") is x


def test_recipe_modes():
    for mode in ("train", "prefill", "decode"):
        rec = make_recipe(mode, multi_pod=True)
        assert rec.dp == ("pod", "data")
        assert rec.site("residual") is not None
    with pytest.raises(ValueError):
        make_recipe("nope")


def test_cache_specs_structure():
    cache = {"pos": np.zeros(()),
             "blocks": {"k": np.zeros((2, 1, 8, 2, 4)),
                        "v": np.zeros((2, 1, 8, 2, 4)),
                        "ssm_state": np.zeros((2, 1, 4, 4, 4)),
                        "conv_state": np.zeros((2, 1, 3, 8))}}
    rec = make_recipe("decode")
    specs = cache_specs(cache, rec)
    assert specs["blocks"]["k"] == P(None, ("data",), "model", None, None)
    assert specs["pos"] == P()


# ------------------------------------------------ parity with the JAX pkg --
@functools.lru_cache(maxsize=None)
def _ref_params(arch, shape):
    import repro.models as rm
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    return rm.param_shapes(rget(arch), RSHAPES[shape])


def _ref_flat(tree):
    import jax
    from jax.sharding import PartitionSpec as RP
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RP))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


class _Mesh:
    def __init__(self, multi):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})


def _entries(spec):
    return tuple(spec)


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch):
    """Every leaf of every arch: param_spec under each mode's recipe, and
    its sanitized form on the 16x16 and 2x16x16 meshes, equal entry by
    entry; the leaves' shapes equal too."""
    from repro.distributed import sharding as rs
    for mode in MODES:
        shape = MODE_SHAPE[mode]
        ref = _ref_params(arch, shape)
        port = param_shapes(get_config(arch), SHAPES[shape])
        rflat, pflat = _ref_flat(ref), _spec_leaves(port)
        pflat = {tuple(str(k) for k in p): v for p, v in pflat}
        assert set(rflat) == set(pflat)
        for multi in (False, True):
            rrec = rs.make_recipe(mode, multi)
            prec = make_recipe(mode, multi)
            rspecs = _ref_flat(rs.param_specs(ref, rrec))
            pspecs = {tuple(str(k) for k in p): v for p, v in
                      _spec_leaves(param_specs(port, prec))}
            mesh = _Mesh(multi)
            for key, leaf in pflat.items():
                assert tuple(leaf.shape) == tuple(rflat[key].shape), key
                assert _entries(pspecs[key]) == _entries(rspecs[key]), key
                assert _entries(sanitize_spec(pspecs[key], leaf.shape,
                                              mesh)) == \
                    _entries(rs.sanitize_spec(rspecs[key], leaf.shape,
                                              mesh)), key


@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_state_specs_equal_the_reference(arch):
    """Decode caches' specs (both meshes' recipes) and AdamW's and
    Adafactor's state specs equal the reference's entry by entry."""
    import jax
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro.distributed import sharding as rs
    from repro.models import input_specs as rinput
    from repro.optim import make_optimizer as rmake
    cfg, rcfg = get_config(arch), rget(arch)
    rcache = rinput(rcfg, RSHAPES["decode_32k"])["cache"]
    pcache = input_specs(cfg, SHAPES["decode_32k"])["cache"]
    for multi in (False, True):
        r = _ref_flat(rs.cache_specs(rcache, rs.make_recipe("decode",
                                                            multi)))
        p = {tuple(str(k) for k in path): v for path, v in
             _spec_leaves(cache_specs(pcache, make_recipe("decode", multi)))}
        assert set(r) == set(p)
        for key in r:
            assert _entries(p[key]) == _entries(r[key]), key
    ref = _ref_params(arch, "train_4k")
    port = param_shapes(cfg, SHAPES["train_4k"])
    for name in ("adamw", "adafactor"):
        rspec = rs.param_specs(ref, rs.make_recipe("train"))
        r = _ref_flat(rmake(name).state_specs(ref, rspec))
        p = {tuple(str(k) for k in path): v for path, v in _spec_leaves(
            make_optimizer(name).state_specs(
                port, param_specs(port, make_recipe("train"))))}
        assert set(r) == set(p), name
        for key in r:
            assert _entries(p[key]) == _entries(r[key]), (name, key)
        # and the states' shapes
        rstate = jax.eval_shape(rmake(name).init, ref)
        pstate = make_optimizer(name).init(port)
        rs_ = {k: tuple(v.shape) for k, v in _ref_flat(rstate).items()}
        ps_ = {tuple(str(k) for k in path): tuple(v.shape)
               for path, v in leaves_with_path(pstate)}
        assert rs_ == ps_, name


def _run(code: str, timeout: int = 120) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_local_shards_are_the_shapes_the_specs_imply():
    """On an 8-rank fake mesh (2x2x2, pod/data/model), DTensor's local
    shard of every param leaf of two archs, under the multi-pod train and
    decode recipes, has the shape the sanitized spec implies (each dim
    divided by its axes' sizes)."""
    out = _run("""
        import math
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.distributed.sharding import (
            make_recipe, param_specs, placements, sanitize_spec)
        from repro_torch.launch.mesh import make_mini_mesh
        from repro_torch.models.registry import param_shapes
        from repro_torch.tree import leaves_with_path
        mesh = make_mini_mesh(multi_pod=True)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n = 0
        for arch in ("deepseek-7b", "kimi-k2-1t-a32b", "mamba2-1.3b"):
            params = param_shapes(get_config(arch), SHAPES["train_4k"])
            for mode in ("train", "decode"):
                pspecs = param_specs(params, make_recipe(mode, True))
                for path, leaf in leaves_with_path(params):
                    spec = pspecs
                    for k in path:
                        spec = spec[k]
                    spec = sanitize_spec(spec, tuple(leaf.shape), mesh)
                    want = list(leaf.shape)
                    for i, ax in enumerate(spec):
                        axes = ax if isinstance(ax, tuple) else (ax,)
                        if ax is not None:
                            want[i] //= math.prod(sizes[a] for a in axes)
                    got, _ = compute_local_shape_and_global_offset(
                        tuple(leaf.shape), mesh, placements(spec, mesh))
                    assert tuple(got) == tuple(want), (arch, path, spec)
                    n += 1
        print("checked", n)
    """)
    assert int(out.split()[-1]) >= 80


def test_hint_and_reshape_redistribute_a_dtensor():
    """On a 2x2 fake mesh: ``hint`` lays a DTensor activation out by the
    site's spec (sanitized: an odd batch stays replicated), and the
    sharding-aware ``reshape`` splits 2 heads sharded over a model axis of
    4 by replicating that axis first, where DTensor's view refuses."""
    _run("""
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.distributed.sharding import (
            P, hint, make_recipe, placements, reshape, use_recipe)
        from repro_torch.launch.mesh import make_mini_mesh
        mesh = make_mini_mesh()
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 3, 4), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False)
            with use_recipe(make_recipe("train")):
                y = hint(x, "residual")
                assert tuple(y.placements) == (Shard(0), Replicate()), \\
                    y.placements
                z = hint(x[:3], "residual")          # 3 % 2: replicated
                assert tuple(z.placements) == (Replicate(), Replicate())
            assert hint(x, "residual") is x          # no recipe
            w = DTensor.from_local(torch.empty(8, 3, 24), mesh,
                                   placements(P(None, None, "model"), mesh),
                                   run_check=False)
            try:                                     # 3 heads over 2
                w.reshape(8, 3, 3, 16)
                raise AssertionError("DTensor split 3 heads over 2")
            except RuntimeError as e:
                assert "unevenly" in str(e), e
            h = reshape(w, 8, 3, 3, 16)
            assert tuple(h.shape) == (8, 3, 3, 16)
            assert tuple(h.to_local().shape) == (8, 3, 3, 16)
            assert reshape(w, 8, 3, 2, 24).placements[1] == Shard(2)
        print("ok")
    """)


def test_make_shard_mesh_clamps_to_one_rank_on_the_cpu():
    """The serving mesh is a ``("shard",)`` mesh over a real one-rank
    gloo group on the CPU, clamped to one device whatever the shard
    count (as the reference clamps it to local devices)."""
    out = _run("""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_shard_mesh
        m = make_shard_mesh(4, kernel_mode="torch")
        print(m.mesh_dim_names, tuple(m.shape), m.device_type,
              dist.get_backend())
    """)
    assert out.strip() == "('shard',) (1,) cpu gloo"
