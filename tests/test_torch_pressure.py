"""Serving past the slab: a working set larger than the memory that holds
it, the port against the JAX package on the CPU.

The paper's database "can continue model serving even if the working
set size exceeds the available memory".  Where a batch's or a model
switch's pages exceed the slab, the reference touches them unpinned and
computes on the host (``dense_fallbacks``); the port serves the same
call on the slab's device through its staging tail and counts it in the
same field.  Both packages open one JAX-written SQLite store and serve
the same traffic, the reference in its device backend's host mode, the
port in ``torch`` and ``host`` mode.

Held exactly: every ``ServeStats`` field that is not a wall-clock time
(``dense_fallbacks`` included), every hit flag the pool returns and
every eviction, in order; the port never calls ``store.materialize`` or
``materialize_rows`` on that path (both raise here).  Held within a
tolerance: embedding logits 1e-5 (the float sums run in another order),
``device_matmul`` 1e-4 of numpy (K ranges summed in fp32).  Bit-equal:
an LM switch's tensors against host materialization, and its greedy
tokens against the reference's.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTextTask as JTask
from repro.db import DedupDB as JDB
from repro.launch.serve import build_store as jbuild_store
from repro.serving.engine import StorageModel as JStorage
from repro.serving.engine import EmbeddingServingEngine as JEngine
from repro.serving.shard_pool import ShardedWeightServer as JSharded
from repro_torch.analysis.sanitizer import PoolSanitizer
from repro_torch.core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from repro_torch.db import DedupDB
from repro_torch.serving import (EmbeddingServingEngine, ShardedWeightServer,
                                 StorageModel, WeightServer, device_pool)
from test_torch_lm_serving import MODELS, ORDER, STEPS, _build_shared
from test_torch_shard_pool import _decisions

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NUM_MODELS, BATCHES, BATCH = 4, 8, 16
LOGIT_TOL = 1e-5
#: ServeStats fields read off the host's clock: every other field must
#: equal the reference's
WALL = {"compute_seconds", "latencies", "timeline_seconds",
        "transfer_seconds"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's word2vec store (d 72: a ragged last stripe),
    heads and task, committed to SQLite."""
    task = JTask(vocab=1024, d=72, seed=3)
    store, heads = jbuild_store(task, NUM_MODELS, block_shape=(32, 32),
                                blocks_per_page=4)
    url = f"sqlite:///{tmp_path_factory.mktemp('db') / 'models.db'}"
    store.save(url)
    traffic = []
    rng = np.random.default_rng(11)
    for b in range(BATCHES):
        v = int(rng.integers(0, NUM_MODELS))
        traffic.append((f"word2vec-v{v}",
                        task.sample(BATCH, variant=v, seed=200 + b)[0]))
    return store, heads, url, traffic


def _no_host_weights(monkeypatch, store):
    """Make every host materialization of a weight raise."""
    def refuse(*a, **k):
        raise AssertionError("the port materialized a weight on the host")
    monkeypatch.setattr(store, "materialize", refuse)
    monkeypatch.setattr(store, "materialize_rows", refuse)


def _record(server):
    """Record every hit flag the server's buffer pools return and every
    eviction they make, in order (a pool that refuses an oversized group
    records nothing for it; its per-page accesses follow)."""
    flags, evicted = [], []
    pools = server.sharded.buffer_pools if hasattr(server, "sharded") \
        else [server.pool]
    for s, bp in enumerate(pools):
        def access(model, pid, s=s, orig=bp.access):
            out = orig(model, pid)
            flags.append((s, int(pid), out))
            return out

        def access_group(model, pids, s=s, orig=bp.access_group):
            out = orig(model, pids)
            flags.append((s, "group", list(out)))
            return out

        def on_evict(pid, s=s, orig=bp.on_evict):
            evicted.append((s, int(pid)))
            orig(pid)
        bp.access, bp.access_group, bp.on_evict = access, access_group, \
            on_evict
    return flags, evicted


def _serve(engine, traffic):
    out = []
    for model, docs in traffic:
        engine.submit(model, docs)
        engine.run(max_batches=1)
        out.append(np.asarray(engine.last_logits, np.float32).copy())
    return out


def _stats(stats):
    """The ServeStats fields that must equal the reference's."""
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats) if f.name not in WALL}


def _batch_pages(store, traffic):
    planner = WeightServer(store, 2, backend="numpy")
    return min(len(planner.embedding_rows_pages(m, "embedding",
                                                np.unique(d)))
               for m, d in traffic)


# ------------------------------------------------------------ single slab --
@pytest.mark.parametrize("frac,mode,tail", [(2, "torch", None),
                                            (4, "torch", None),
                                            (2, "host", None),
                                            (4, "host", None),
                                            (4, "torch", 1),
                                            (2, "host", 3)])
def test_embedding_past_the_slab_equals_the_reference(reference, monkeypatch,
                                                      frac, mode, tail):
    """At half and a quarter of the store, below every batch's page set,
    each batch is served on the slab's device through the staging tail
    (``tail``: its pages, default ``tail_size``; 1 and 3 force more
    page groups) with the reference's logits,
    ServeStats, hit flags and evictions, and no weight materialized on
    the host."""
    if tail is not None:
        monkeypatch.setattr(device_pool, "TAIL_PAGES", tail)
    jstore, heads, url, traffic = reference
    cap = jstore.num_pages() // frac
    assert cap < _batch_pages(jstore, traffic)
    jdb = JDB.open(url)
    jeng = jdb.serve_embedding(heads, capacity_pages=cap,
                               storage=JStorage("dram"),
                               compute_backend="device", kernel_mode="host",
                               scheduler="dedup_affinity", overlap=True)
    jflags, jevicted = _record(jeng.server)
    want = _serve(jeng, traffic)
    db = DedupDB.open(url)
    _no_host_weights(monkeypatch, db.store)
    server = WeightServer(db.store, cap, storage=StorageModel("dram"),
                          kernel_mode=mode)
    engine = EmbeddingServingEngine(server, heads,
                                    scheduler="dedup_affinity", overlap=True)
    flags, evicted = _record(server)
    got = _serve(engine, traffic)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL, rtol=0)
    assert jeng.stats.dense_fallbacks == BATCHES
    assert _stats(engine.stats) == _stats(jeng.stats)
    assert (flags, evicted) == (jflags, jevicted)
    assert server.pool.hit_ratio == jeng.server.pool.hit_ratio
    pool = server.device_pool
    assert pool.tail_calls == BATCHES
    assert pool.tail_chunks >= BATCHES and pool.tail_staged > 0
    # the tail is outside the pool: residency is the reference's
    assert pool.resident_pages() == jeng.server.device_pool.resident_pages()
    jdb.close()
    db.close()


def _ffnn(seed=0):
    """Two FFNN variants of W [640, 200] in 32x32 blocks, 4 a page (the
    second perturbs its first rows)."""
    rng = np.random.default_rng(seed)
    store = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2, r=4.0,
                                        collision_threshold=6),
                          validate=False),
        blocks_per_page=4))
    w = (rng.standard_normal((640, 200)) * 0.1).astype(np.float32)
    store.register("f0", {"W": w})
    w1 = w.copy()
    w1[:96] += 0.05
    store.register("f1", {"W": w1})
    x = rng.standard_normal((8, 640)).astype(np.float32)
    return store, x


@pytest.mark.parametrize("mode", ["torch", "host"])
@pytest.mark.parametrize("tail", [None, 2])
def test_device_matmul_past_the_slab(monkeypatch, mode, tail):
    """``device_matmul`` with a slab below W's pages: K ranges through the
    tail (column ranges where one block row alone does not fit), within
    1e-4 of numpy; the call changes no residency or remap generation."""
    if tail is not None:
        monkeypatch.setattr(device_pool, "TAIL_PAGES", tail)
    store, x = _ffnn()
    pages = len(store.model_pages("f1"))
    cap = pages // 3
    server = WeightServer(store, cap, storage=StorageModel("dram"),
                          kernel_mode=mode)
    server.access_pages("f1", store.model_pages("f1"))
    pool = server.device_pool
    resident, gen = pool.resident_pages(), pool.generation
    y = np.asarray(server.device_matmul("f1", "W", x))
    np.testing.assert_allclose(y, x @ store.materialize("f1", "W"),
                               rtol=1e-4, atol=1e-4)
    assert pool.tail_calls == 1
    assert pool.tail_chunks > (1 if tail else 0)
    assert (pool.resident_pages(), pool.generation) == (resident, gen)
    # the whole tensor through the tail is the host's, bit for bit
    t = np.asarray(server.device_tensor("f1", "W"))
    np.testing.assert_array_equal(t, store.materialize("f1", "W"))


def test_tail_is_small_beside_the_slab(monkeypatch):
    """The staging tail is ``TAIL_PAGES`` pages, at most half the slab
    and at least 1, whatever the store holds beyond the slab, so a slab
    sized to fill the device asks for little more; a shard's overflow
    rows follow its borrow rows."""
    store, _ = _ffnn()
    monkeypatch.setattr(device_pool, "TAIL_PAGES", 3)
    for cap, want in ((1, 1), (2, 1), (4, 2), (6, 3), (store.num_pages(), 3)):
        srv = WeightServer(store, cap, kernel_mode="torch")
        assert srv.device_pool.overflow_rows == want
        assert srv.device_pool.stage_rows == want
        assert srv.device_pool.slab.shape[0] == cap + want
    srv = ShardedWeightServer(store, 4, shards=2, kernel_mode="torch",
                              borrow_capacity=3)
    assert [(p.stage_rows, p.overflow_rows) for p in srv.sharded.pools] \
        == [(5, 2), (5, 2)]
    assert device_pool.tail_size(10 ** 6) == 3


# --------------------------------------------------------------- LM switch --
@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The reference's reduced deepseek-7b store (two variants) in SQLite
    and both packages' APIs, as ``tests/test_torch_lm_serving.py`` builds
    them."""
    return _build_shared("deepseek-7b", tmp_path_factory.mktemp("lm"))


@pytest.mark.parametrize("mode", ["torch", "host"])
def test_lm_switch_past_the_slab(lm, monkeypatch, mode):
    """At half the store, below a variant's page set, every switch comes
    through the staging tail: its tensors bit-equal to host
    materialization, the reference's greedy tokens, ServeStats, hit flags
    and evictions, and no weight materialized on the host."""
    cap = lm["pages"] // 2
    assert cap < lm["model_pages"]
    jdb = JDB.open(lm["url"])
    jeng = jdb.serve_lm({m: lm["japi"] for m in MODELS},
                        {m: {"rebuild": lm["jrebuild"]} for m in MODELS},
                        capacity_pages=cap, storage=JStorage("dram"),
                        compute_backend="device", kernel_mode="host")
    jflags, jevicted = _record(jeng.server)
    db = DedupDB.open(lm["url"])
    host = {(m, t): db.store.materialize(m, t) for m in MODELS
            for t in db.store.dedup.models[m].tensors}
    _no_host_weights(monkeypatch, db.store)
    engine = db.serve_lm({m: lm["tapi"] for m in MODELS},
                         {m: {"rebuild": lm["lm"].rebuild} for m in MODELS},
                         capacity_pages=cap, storage=StorageModel("dram"),
                         kernel_mode=mode)
    flags, evicted = _record(engine.server)
    for model, prompts in zip(ORDER, lm["prompts"]):
        jeng.submit(model, prompts, steps=STEPS)
        jeng.run(max_batches=1)
        engine.submit(model, prompts, steps=STEPS)
        engine.run(max_batches=1)
        np.testing.assert_array_equal(np.asarray(engine.last_tokens),
                                      np.asarray(jeng.last_tokens))
    assert engine.stats.dense_fallbacks == jeng.stats.dense_fallbacks == 3
    assert _stats(engine.stats) == _stats(jeng.stats)
    assert (flags, evicted) == (jflags, jevicted)
    for (m, t), want in list(host.items())[:6]:
        got = engine.server.device_tensor(m, t)
        np.testing.assert_array_equal(np.asarray(got), want)
    jdb.close()
    db.close()


# ------------------------------------------------------------------ shards --
@pytest.mark.parametrize("site", ["owned_group", "borrow_set"])
@pytest.mark.parametrize("mode", ["torch", "host"])
def test_sharded_sites_equal_the_reference(reference, monkeypatch, site,
                                           mode):
    """2 hash shards: an owned group larger than a shard's capacity
    (``owned_group``) or a borrow set larger than ``borrow_capacity``
    (``borrow_set``) is served through the shard's overflow rows, with
    the reference's logits, route and borrow counters, per-shard pool
    decisions, ServeStats, hit flags and evictions."""
    jstore, heads, url, traffic = reference
    if site == "owned_group":
        kw = dict(capacity_pages=jstore.num_pages() // 4)
    else:
        kw = dict(capacity_pages=jstore.num_pages(), borrow_capacity=2)
    jdb = JDB.open(url)
    jsrv = JSharded(jdb.store, storage=JStorage("dram"), shards=2,
                    placement="hash", kernel_mode="host", **kw)
    jflags, jevicted = _record(jsrv)
    jeng = JEngine(jsrv, heads, scheduler="fifo", overlap=True)
    want = _serve(jeng, traffic)
    db = DedupDB.open(url)
    _no_host_weights(monkeypatch, db.store)
    srv = ShardedWeightServer(db.store, storage=StorageModel("dram"),
                              shards=2, placement="hash", kernel_mode=mode,
                              **kw)
    flags, evicted = _record(srv)
    engine = EmbeddingServingEngine(srv, heads, scheduler="fifo",
                                    overlap=True)
    got = _serve(engine, traffic)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, atol=LOGIT_TOL, rtol=0)
    assert jeng.stats.dense_fallbacks > 0
    assert _stats(engine.stats) == _stats(jeng.stats)
    assert _stats(srv.stats) == _stats(jsrv.stats)
    assert (flags, evicted) == (jflags, jevicted)
    assert _decisions(srv) == _decisions(jsrv)
    assert srv.sharded.tail_calls == engine.stats.dense_fallbacks
    srv.sharded.check_invariants()
    jdb.close()
    db.close()


# --------------------------------------------------------------- sanitizer --
@pytest.mark.parametrize("shards", [1, 2])
def test_sanitizer_sees_no_violation_past_the_slab(reference, shards):
    """The strict port PoolSanitizer, attached to the pools of a server at
    a quarter of the store, records no violation, and the logits are
    bit-equal to the same run uninstrumented."""
    jstore, heads, url, traffic = reference
    cap = jstore.num_pages() // 4

    def run(san):
        db = DedupDB.open(url)
        if shards == 1:
            srv = WeightServer(db.store, cap, storage=StorageModel("dram"),
                               kernel_mode="torch")
        else:
            srv = ShardedWeightServer(db.store, cap,
                                      storage=StorageModel("dram"),
                                      shards=2, placement="hash",
                                      kernel_mode="torch")
        if san is not None:
            if shards == 1:
                san.attach_device_pool(srv.device_pool)
                san.attach_buffer_pool(srv.pool)
                srv.pool.on_load = srv.device_pool.load
                srv.pool.on_evict = srv.device_pool.evict
                srv.pool.on_load_group = srv.device_pool.load_group
            else:
                san.attach_sharded_pool(srv.sharded)
                for bp, pool in zip(srv.sharded.buffer_pools,
                                    srv.sharded.pools):
                    bp.on_evict = pool.evict
        engine = EmbeddingServingEngine(srv, heads, scheduler="fifo",
                                        overlap=True)
        out = _serve(engine, traffic)
        assert engine.stats.dense_fallbacks > 0
        db.close()
        return out
    plain = run(None)
    san = PoolSanitizer(strict=True)
    checked = run(san)
    assert not san.violations and len(san.events) > 0
    for a, b in zip(plain, checked):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- CLI --
def test_lm_cli_default_capacity_equals_the_reference():
    """Both LM CLIs size the slab alike: the default (``--capacity-pages``
    24) and ``--capacity-pages 0`` (half the store's pages, at least 2)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    common = ["--engine", "lm", "--vocab", "512", "--batches", "1",
              "--backend", "device"]
    runs = {}
    for extra in ([], ["--capacity-pages", "0"]):
        port = [sys.executable, "-m", "repro_torch.launch.serve", *common,
                "--kernel-mode", "torch", "--index-mode", "host", *extra]
        ref = [sys.executable, "-m", "repro.launch.serve", *common, *extra]
        runs[tuple(extra)] = [subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT)) for cmd in (port, ref)]
    slabs = {}
    for extra, procs in runs.items():
        got = []
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-2000:]
            pages = int(re.search(r"^\[store\] lm models=\d+ pages=(\d+)",
                                  out, re.M).group(1))
            slab = int(re.search(r"^\[device\] slab=(\d+)", out,
                                 re.M).group(1))
            got.append((pages, slab))
        assert got[0] == got[1], (extra, got)
        slabs[extra] = got[0]
    assert slabs[()][1] == 24
    pages, slab = slabs[("--capacity-pages", "0")]
    assert slab == max(2, pages // 2)
