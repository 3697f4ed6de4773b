"""Slice 2 as a whole: the port's LM engine serves a store the JAX
package wrote, token for token.

The setup of ``tests/test_lm_serving.py``: the reduced deepseek-7b (and,
for the other families, the reduced hymba-1.5b, kimi-k2 and mamba2-1.3b)
is initialised by JAX, flattened with the reference CLI's naming and
registered as two variants (the second shifted by 1e-5) into a JAX
``ModelStore`` of 32x32 blocks, committed to SQLite.  The JAX
``LMServingEngine`` (device backend, host kernel mode) and the port's
(``torch`` and ``host`` modes) open that one database and serve the
same batches; the greedy tokens must be equal and the buffer pools must
make the same decisions.  Where the slab cannot hold a variant the
reference falls back to the host, the port serves the switch through
the slab's staging tail in every mode, counted the same way; only a
fetch that fails past its retry budget goes to the host, in the CPU
modes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from repro.db import DedupDB as JDB
from repro.models import build as jbuild
from repro.serving.engine import StorageModel as JStorage
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.db import DedupDB
from repro_torch.models import build
from repro_torch.serving.engine import StorageModel
from repro_torch.storage.faults import StorageFaultError

torch.set_num_threads(2)

MODELS = ("lm-v0", "lm-v1")
ORDER = ["lm-v0", "lm-v1", "lm-v1", "lm-v0"]
STEPS = 4
#: the other families' reduced configs served from a JAX-written store
FAMILIES = ["hymba-1.5b", "kimi-k2-1t-a32b", "mamba2-1.3b"]


def _build_shared(arch, tmp_dir):
    """The reference's LM store of one reduced arch in SQLite, the JAX
    side of serving it and the port's (apis + rebuild templates of the
    same exported weights)."""
    cfg = jreduced(jget_config(arch))
    japi = jbuild(cfg)
    params = japi.init(jax.random.PRNGKey(0), 64)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)

    def key_of(path):
        return "/".join(str(getattr(p, "key", p)) for p in path)

    tensors = {key_of(p): np.asarray(l, np.float32).reshape(l.shape[0], -1)
               if l.ndim > 2 else np.asarray(l, np.float32)
               for p, l in flat}
    shapes = {key_of(p): l.shape for p, l in flat}
    dtypes = {key_of(p): l.dtype for p, l in flat}

    def jrebuild(ts):
        import jax.numpy as jnp
        leaves = [jnp.asarray(np.asarray(ts[key_of(p)])
                              .reshape(shapes[key_of(p)]),
                              dtypes[key_of(p)]) for p, _ in flat]
        return jax.tree_util.tree_unflatten(treedef, leaves)

    store = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2,
                                        r=4.0, collision_threshold=6),
                          validate=False),
        blocks_per_page=8))
    store.register("lm-v0", tensors)
    store.register("lm-v1", {k: v + 1e-5 for k, v in tensors.items()})
    url = f"sqlite:///{tmp_dir / 'lm.db'}"
    store.save(url)

    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    tapi = build(reduced(get_config(arch)))
    prompts = [np.random.default_rng(b).integers(1, 256, size=(2, 12))
               .astype(np.int32) for b in range(len(ORDER))]
    return dict(url=url, japi=japi, jrebuild=jrebuild, tapi=tapi, lm=lm,
                prompts=prompts, pages=store.num_pages(),
                model_pages=max(len(store.model_pages(m)) for m in MODELS))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return _build_shared("deepseek-7b", tmp_path_factory.mktemp("lm"))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    return _build_shared(request.param, tmp_path_factory.mktemp("family"))


def _jax_engine(shared, cap):
    db = JDB.open(shared["url"])
    return db.serve_lm({m: shared["japi"] for m in MODELS},
                       {m: {"rebuild": shared["jrebuild"]} for m in MODELS},
                       capacity_pages=cap, storage=JStorage("dram"),
                       compute_backend="device", kernel_mode="host")


def _port_engine(shared, cap, mode):
    db = DedupDB.open(shared["url"])
    return db.serve_lm({m: shared["tapi"] for m in MODELS},
                       {m: {"rebuild": shared["lm"].rebuild} for m in MODELS},
                       capacity_pages=cap, storage=StorageModel("dram"),
                       kernel_mode=mode)


def _serve(engine, shared):
    out = []
    for model, prompts in zip(ORDER, shared["prompts"]):
        engine.submit(model, prompts, steps=STEPS)
        engine.run(max_batches=1)
        out.append(np.asarray(engine.last_tokens))
    return out


def _decisions(engine):
    s = engine.stats
    return (engine.server.pool.hit_ratio, engine.server.stats.pages_fetched,
            s.batches, s.device_batches, s.dense_fallbacks)


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_port_serves_the_reference_lm_store(shared, mode):
    """A slab that holds one variant's page set: every switch reassembles
    the weights from the slab, and the switches evict."""
    cap = shared["model_pages"]
    want_engine = _jax_engine(shared, cap)
    want = _serve(want_engine, shared)
    engine = _port_engine(shared, cap, mode)
    got = _serve(engine, shared)
    assert engine.server.device_pool.mode() == mode
    assert engine.stats.device_batches == 3      # v0, v1, v0: 3 switches
    assert engine.stats.dense_fallbacks == 0
    for a, b in zip(want, got):
        assert a.shape == (2, STEPS)
        np.testing.assert_array_equal(a, b)
    assert _decisions(engine) == _decisions(want_engine)


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_port_serves_the_reference_family_store(family, mode):
    """The reduced hybrid (hymba), MoE (kimi-k2) and SSM (mamba2) models,
    JAX-written and served by both engines from one database: the same
    greedy tokens and the same pool decisions, every switch on the
    slab."""
    cap = family["model_pages"]
    want_engine = _jax_engine(family, cap)
    want = _serve(want_engine, family)
    engine = _port_engine(family, cap, mode)
    got = _serve(engine, family)
    assert engine.stats.device_batches == 3
    assert engine.stats.dense_fallbacks == 0
    for a, b in zip(want, got):
        assert a.shape == (2, STEPS)
        np.testing.assert_array_equal(a, b)
    assert _decisions(engine) == _decisions(want_engine)


@pytest.mark.parametrize("trigger", ["oversized_group", "not_resident",
                                     "storage_fault"])
def test_only_cpu_modes_fall_back_to_the_host(shared, monkeypatch, trigger):
    """A model switch whose fetch fails past its retry budget is
    materialized on the host in torch mode, as the reference does
    (counted), and raises in cuda mode -- stood for on the CPU by forcing
    ``host_fallback_allowed`` to false.  A switch the slab cannot hold (a
    working set larger than the pool, or pages left non-resident) comes
    through the slab's staging tail in every mode: the reference's
    tokens, counted in ``dense_fallbacks`` as the reference counts its
    host materialization."""
    cap = shared["model_pages"] - 1 if trigger == "oversized_group" \
        else shared["model_pages"]
    want_engine = _jax_engine(shared, cap)
    want = _serve(want_engine, shared)
    for on_card in (False, True):
        engine = _port_engine(shared, cap, "torch")
        server = engine.server
        if trigger == "not_resident":
            monkeypatch.setattr(server.pool, "access_group",
                                lambda m, pids: [True] * len(pids))
        elif trigger == "storage_fault":
            def fail(*a, **k):
                raise StorageFaultError("injected: retry budget spent")
            monkeypatch.setattr(server, "access_pages", fail)
        if on_card:
            monkeypatch.setattr(server, "host_fallback_allowed",
                                lambda: False)
        if on_card and trigger == "storage_fault":
            engine.submit("lm-v0", shared["prompts"][0], steps=STEPS)
            with pytest.raises((RuntimeError, ValueError, StorageFaultError)):
                engine.run(max_batches=1)
            assert engine.stats.batches == 0
            assert engine.stats.dense_fallbacks == 0
            continue
        got = _serve(engine, shared)
        assert engine.stats.device_batches == 0
        assert engine.stats.dense_fallbacks == 3
        if trigger == "storage_fault":
            continue
        assert server.device_pool.tail_calls > 0
        if trigger == "oversized_group":
            # the reference takes its host fallback on the same slab
            assert want_engine.stats.dense_fallbacks == 3
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_cli_lm_engine_on_the_host_simulator():
    """``--engine lm --backend numpy`` serves on the CPU; the default
    backend means the card and refuses without one."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
            "lm", "--batches", "3", "--lm-steps", "3"]
    out = subprocess.run(base + ["--backend", "numpy"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    serve = [l for l in out.stdout.splitlines() if l.startswith("[serve]")]
    assert len(serve) == 1 and "batches=3 requests=6" in serve[0]
    if not torch.cuda.is_available():
        out = subprocess.run(base, capture_output=True, text=True, env=env,
                             timeout=300, cwd=root)
        assert out.returncode != 0
        assert "[serve]" not in out.stdout
        assert "no CUDA device" in out.stderr
