"""The port's dry-run against the JAX package's.

Ports of ``tests/test_dryrun_mini.py`` (the cells run in subprocesses
on a fake 2x2 / 2x2x2 world, and keep their ``slow`` marks; the
one-device check becomes "this process holds no default process
group"); the record's shape-only fields (``params_total``,
``params_active``, ``model_flops`` and the global param / optimizer /
cache bytes) exactly equal to the reference's for all 32 runnable cells,
computed from ``repro.models.param_shapes`` / ``input_specs`` and
``jax.eval_shape``; ``input_specs`` and ``param_shapes`` key for key
with shape and dtype; ``make_batch_from_specs`` bit-equal to the
reference's on reduced configs; the 8 ``long_500k`` skips with the
reference's reasons; the roofline formulas.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (SHAPES, ShapeSpec, get_config, list_archs,
                                 reduced, shape_supported)
from repro_torch.data.specs import make_batch_from_specs
from repro_torch.launch.dryrun import (cell_sizes, lower_cell,
                                       model_flops_estimate)
from repro_torch.models.registry import input_specs, param_shapes
from repro_torch.roofline import (HW, collective_bytes, roofline_terms,
                                  summarize_cell)
from repro_torch.tree import leaves_with_path

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
CELLS = [(a, s) for a in list_archs() for s in SHAPES]
RUNNABLE = [c for c in CELLS if shape_supported(get_config(c[0]), c[1])[0]]


def run_cell(tmp, arch, shape, multi=False, variant="baseline"):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mini", "--out", tmp,
           "--variant", variant]
    if multi:
        cmd.append("--multi-pod")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=540)
    assert r.returncode == 0, r.stderr[-2000:]
    mesh = "multi" if multi else "single"
    v = "" if variant == "baseline" else f"__{variant}"
    with open(os.path.join(tmp, f"{arch}__{shape}__{mesh}{v}.json")) as f:
        return json.load(f)


# ----------------------------------------- ports of test_dryrun_mini.py --
@pytest.mark.slow
def test_skip_rule_recorded(tmp_path):
    rec = run_cell(str(tmp_path), "qwen3-14b", "long_500k")
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["reason"]


def test_main_process_has_no_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_production_mesh_shapes():
    """Pure metadata check (no devices needed)."""
    assert len(CELLS) == 40
    assert len(RUNNABLE) == 32             # 8 long_500k skips


# ---------------------------------------------- parity with the JAX pkg --
@functools.lru_cache(maxsize=None)
def _ref(arch, shape):
    import jax
    import repro.models as rm
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget
    from repro.optim import make_optimizer as rmake
    cfg, spec = rget(arch), RSHAPES[shape]
    params = rm.param_shapes(cfg, spec)
    batch = rm.input_specs(cfg, spec)
    opt = jax.eval_shape(rmake(cfg.optimizer).init, params) \
        if spec.kind == "train" else None
    return cfg, params, batch, opt


def _ref_bytes(tree) -> int:
    import jax
    return sum(math.prod(l.shape) * np.dtype(l.dtype).itemsize
               for l in jax.tree.leaves(tree))


def _ref_leaves(tree):
    import jax
    return {tuple(str(getattr(k, "key", k)) for k in p): l
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {tuple(str(k) for k in p): l for p, l in leaves_with_path(tree)}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", RUNNABLE,
                         ids=[f"{a}-{s}" for a, s in RUNNABLE])
def test_cell_meta_equals_the_reference(arch, shape):
    """The six shape-only fields of each runnable cell's record equal the
    reference's exactly; ``input_specs`` and ``param_shapes`` equal key
    for key, with shape and dtype."""
    from repro.configs.base import ShapeSpec as RShape
    rcfg, rparams, rbatch, ropt = _ref(arch, shape)
    cfg, spec = get_config(arch), SHAPES[shape]
    rspec = RShape(spec.name, spec.seq_len, spec.global_batch, spec.kind)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    n_act = rcfg.active_param_count()
    want_flops = {"train": 6.0 * n_act * spec.global_batch * spec.seq_len,
                  "prefill": 2.0 * n_act * spec.global_batch * spec.seq_len,
                  "decode": 2.0 * n_act * spec.global_batch}[spec.kind]
    assert model_flops_estimate(cfg, spec) == want_flops
    assert rspec.kind == spec.kind
    sizes = cell_sizes(cfg, spec)
    want = {"param_bytes_global": _ref_bytes(rparams)}
    if ropt is not None:
        want["opt_bytes_global"] = _ref_bytes(ropt)
    if "cache" in rbatch:
        want["cache_bytes_global"] = _ref_bytes(rbatch["cache"])
    assert sizes == want
    for ref_tree, port_tree in ((rparams, param_shapes(cfg, spec)),
                                (rbatch, input_specs(cfg, spec))):
        r, p = _ref_leaves(ref_tree), _port_leaves(port_tree)
        assert set(r) == set(p)
        for k in r:
            assert tuple(p[k].shape) == tuple(r[k].shape), k
            assert _dtype_name(p[k].dtype) == str(np.dtype(r[k].dtype)), k


@pytest.mark.parametrize("arch", list_archs())
def test_make_batch_from_specs_bit_equal(arch):
    """Train, prefill and decode batches of the reduced config, in its
    dtype and in bf16: the same draws as the reference, bit for bit."""
    import jax
    import ml_dtypes
    from repro.configs import get_config as rget
    from repro.configs import reduced as rreduced
    from repro.configs.base import ShapeSpec as RShape
    from repro.data.pipeline import make_batch_from_specs as rmake
    from repro.models import input_specs as rinput
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
        rcfg = dataclasses.replace(rreduced(rget(arch)), dtype=dtype)
        for kind in ("train", "prefill", "decode"):
            spec, rspec = ShapeSpec("t", 24, 2, kind), RShape("t", 24, 2, kind)
            r = _ref_leaves(rmake(rinput(rcfg, rspec), seed=5))
            p = _port_leaves(make_batch_from_specs(input_specs(cfg, spec),
                                                   seed=5))
            assert list(r) == sorted(r) and set(r) == set(p)
            for k in r:
                x = np.asarray(r[k])
                y = p[k]
                if y.dtype == torch.bfloat16:
                    assert x.dtype == ml_dtypes.bfloat16, k
                    x, y = x.view(np.uint16), y.view(torch.int16).numpy() \
                        .view(np.uint16)
                else:
                    y = y.numpy()
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=str(k))


def test_long_500k_skips_match_the_reference():
    """The 8 long_500k cells the reference skips are skipped with its
    reason, recorded before any mesh is made."""
    from repro.configs import get_config as rget
    from repro.configs import shape_supported as rsupported
    skipped = []
    for arch in list_archs():
        ok, reason = rsupported(rget(arch), "long_500k")
        assert shape_supported(get_config(arch), "long_500k") == (ok, reason)
        if ok:
            continue
        rec = lower_cell(arch, "long_500k")
        assert rec["status"] == "skipped" and rec["reason"] == reason
        assert rec["meta"]["model_flops"] == model_flops_estimate(
            get_config(arch), SHAPES["long_500k"])
        skipped.append(arch)
    assert len(skipped) == 8
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_roofline_formulas():
    """The reference's formulas with the H100's datasheet numbers; the
    collective counter's keys are the reference's HLO counter's."""
    from repro.roofline.analysis import collective_bytes_from_hlo
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                  "nvlink_bw": 450e9}
    t = roofline_terms(989e12, 6.7e12, 9e11)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "memory_s"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    c = collective_bytes([("all-gather", 100), ("all-reduce", 10),
                          ("reduce-scatter", 1), ("all-reduce", 5)])
    assert set(c) == set(collective_bytes_from_hlo(""))
    assert (c["count"], c["total"], c["weighted_total"]) == (4, 116, 131)
    with pytest.raises(ValueError):
        collective_bytes([("gossip", 1)])
    rec = {"meta": {"arch": "a"}, "cost_analysis": {
        "flops": 2 * 989e12, "bytes accessed": 3.35e12},
        "collectives": c}
    row = summarize_cell(rec, model_flops=989e12)
    assert row["arch"] == "a" and row["dominant"] == "compute_s"
    assert row["useful_flops_ratio"] == pytest.approx(0.5)
    assert row["collective_bytes"] == 131
