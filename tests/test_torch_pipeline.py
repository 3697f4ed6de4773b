"""The port's GPipe schedule against the JAX package's.

The reference self-check's workload (a 4-layer tanh MLP, 2 stages x 2
layers, 3 microbatches [8, 16]) through ``pipeline_apply`` within 1e-6
of the JAX sequential chain on the same numpy draws; a reduced
deepseek-7b split into 2 stages, bit-equal on the CPU to the port's
unpipelined forward of each microbatch; the schedule's order (each
stage runs each microbatch once, stage s at tick m + s); and the
self-check CLI.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.models import transformer
from repro_torch.tree import tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_self_check_workload_matches_the_jax_chain():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    mb = rng.standard_normal((3, 8, 16)).astype(np.float32)

    def two_layers(w_pair, x):
        for i in range(2):
            x = torch.tanh(x @ w_pair[i])
        return x

    out = pipeline_apply(two_layers, torch.from_numpy(W).reshape(2, 2, 16, 16),
                         torch.from_numpy(mb), kernel_mode="torch")
    ref = jnp.asarray(mb)
    for i in range(4):
        ref = jnp.tanh(ref @ jnp.asarray(W[i]))
    assert out.shape == (3, 8, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_schedule_order_and_bubble():
    """Each stage runs each microbatch once, stage s at tick m + s, in
    the reference's schedule of M + S - 1 ticks; a list of per-stage
    params works like a leading stage axis."""
    calls = []

    def stage(p, x):
        calls.append((int(p), int(x[0])))
        return x + 10 * (p + 1)

    mb = torch.arange(4, dtype=torch.int64)[:, None]      # 4 microbatches
    out = pipeline_apply(stage, [torch.tensor(0), torch.tensor(1),
                                 torch.tensor(2)], mb, kernel_mode="torch")
    assert out[:, 0].tolist() == [60, 61, 62, 63]
    # the schedule's order: tick t runs (stage s, microbatch t - s)
    want = [(s, m + 10 * sum(range(1, s + 1)))
            for t in range(4 + 3 - 1) for s in range(3)
            for m in [t - s] if 0 <= m < 4]
    assert calls == want
    assert bubble_fraction(2, 4) == pytest.approx(0.2)
    assert bubble_fraction(2, 3) == pytest.approx(0.25)


def test_reduced_deepseek_two_stages_bit_equal():
    """Reduced deepseek-7b, its layers split into 2 stages over the
    embedded prompt, 3 microbatches of 1 x 12: bit-equal to running all
    its layers on each microbatch without the schedule."""
    cfg = reduced(get_config("deepseek-7b"))
    L = cfg.num_layers
    assert L % 2 == 0
    params = convert.train_params(transformer.init_params(cfg, 3), cfg)
    g = transformer.build_groups(cfg)[0]
    half = transformer.GroupSpec(g.name, g.kind, L // 2, g.windows[:L // 2])
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1, 12)))
    with torch.no_grad():
        x = torch.stack([transformer.embed(t, params["embed"],
                                           cfg.embed_scale)
                         for t in tokens])
        pos = torch.arange(12)[None, :]
        h = L // 2
        stages = [tree_map(lambda a, s=s: a[s * h:(s + 1) * h],
                           params[g.name]) for s in range(2)]

        def stage_fn(p, h):
            return transformer._run_group(h, p, half, cfg, pos, False)

        out = pipeline_apply(stage_fn, stages, x, kernel_mode="torch")
        ref = torch.stack([transformer._run_group(x[m], params[g.name], g,
                                                  cfg, pos, False)
                           for m in range(3)])
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, ref)


def test_self_check_cli():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.distributed.pipeline"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "max err: 0.00e+00" in r.stdout
