"""The port's sharded page slab (serving/router.py + serving/shard_pool.py)
held against the JAX package on the CPU.

Counterparts of the functions of ``tests/test_shard_pool.py``, plus the
2-shard chaos run with a mid-run failover of ``tests/test_faults.py`` and
the sharded grouped-vs-per-page run of ``tests/test_transfer.py``.  The
reference writes each word2vec store to SQLite; both packages open that
one file live.  The port runs in its ``torch`` and ``host`` kernel modes,
the reference in ``host`` mode and in Pallas interpret mode, as its own
tests run it.

Tolerances: logits within 1e-5 (atol) of the reference's, and of the
port's own single-slab and numpy runs — the float sums run in another
order; LM tokens, placements, routes, per-shard pool decisions (hits,
misses, evictions, resident sets), ``shard_batches``, the borrow counters
(pages, mirror hits, store faults, coalesced), ``rebalanced``, staged
slots and failovers equal exactly; a failover run under injected faults
bit-equal to the same run without faults, as in the reference.
"""
import functools

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core import ModelStore as JModelStore
from repro.data.pipeline import SyntheticTextTask as JTask
from repro.launch.serve import build_store as jbuild_store
from repro.serving.engine import EmbeddingServingEngine as JEngine
from repro.serving.engine import LMServingEngine as JLMEngine
from repro.serving.engine import StorageModel as JStorage
from repro.serving.engine import WeightServer as JServer
from repro.serving.router import ShardRouter as JRouter
from repro.serving.shard_pool import ShardedPagePool as JShardedPool
from repro.serving.shard_pool import ShardedWeightServer as JSharded
from repro.serving.shard_pool import hash_placement as jhash_placement
from repro.serving.shard_pool import make_placement as jmake_placement
from repro.serving.shard_pool import sharers_placement as jsharers_placement
from repro.storage import MemoryBackend as JMemoryBackend
from repro.storage.faults import FaultInjectingBackend as JFaulty
from repro.storage.faults import FaultSpec as JFaultSpec
from repro_torch.core import (DedupConfig, LSHConfig, ModelStore,
                              StoreConfig)
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import build_store
from repro_torch.serving import (PLACEMENTS, EmbeddingServingEngine,
                                 LMServingEngine, ShardedPagePool,
                                 ShardedWeightServer, ShardRouter,
                                 StorageModel, WeightServer, hash_placement,
                                 make_placement, sharers_placement)
from repro_torch.storage import MemoryBackend
from repro_torch.storage.faults import FaultInjectingBackend, FaultSpec

torch.set_num_threads(2)

LOGIT_TOL = 1e-5


# ---------------------------------------------------------------- stores --
@pytest.fixture(scope="module")
def jax_db(tmp_path_factory):
    """``jax_db(vocab, num_models)`` -> the URL of a word2vec store the
    reference built and committed to SQLite (32x32 blocks, 4 a page)."""
    root = tmp_path_factory.mktemp("shard_dbs")

    @functools.lru_cache(maxsize=None)
    def make(vocab, num_models):
        task = JTask(vocab=vocab, d=32, seed=0)
        store, _ = jbuild_store(task, num_models=num_models,
                                block_shape=(32, 32), blocks_per_page=4)
        url = f"sqlite:///{root / f'w2v-{vocab}-{num_models}.db'}"
        store.save(url)
        return url
    return make


def _heads(vocab, num_models):
    """The scenario's task and heads (seeded, the same in both
    packages)."""
    task = SyntheticTextTask(vocab=vocab, d=32, seed=0)
    rng = np.random.default_rng(1)
    heads = {f"word2vec-v{v}": (rng.standard_normal((32, 2)) * 0.5)
             .astype(np.float32) for v in range(num_models)}
    return task, heads


def _open_both(url):
    jstore, store = JModelStore.open(url), ModelStore.open(url)
    assert store.num_pages() == jstore.num_pages()
    return jstore, store


def _docs(task, num_models, batches, batch, seed=0):
    return [(f"word2vec-v{b % num_models}",
             task.sample(batch, variant=b % num_models,
                         seed=seed + 100 + b)[0]) for b in range(batches)]


def _run(engine, traffic):
    out = []
    for model, docs in traffic:
        engine.submit(model, docs)
        engine.run(max_batches=1)
        out.append(np.asarray(engine.last_logits, np.float32).copy())
    return out


def _decisions(srv):
    """Everything of a sharded server that must equal the reference's."""
    sp = srv.sharded
    s = srv.stats
    return {
        "pools": [(bp.hits, bp.misses, bp.evictions, sorted(bp.resident_pages()))
                  for bp in sp.buffer_pools],
        "slabs": [sorted(p.slot_of.items()) for p in sp.pools],
        "staged": [sorted(sp.staged(i).items()) for i in range(sp.num_shards)],
        "shard_batches": dict(s.shard_batches),
        "borrows": (s.borrow_pages, s.borrow_mirror_hits,
                    s.borrow_store_faults, s.borrow_coalesced,
                    s.pages_fetched),
        "pool_borrows": (sp.borrow_mirror_hits, sp.borrow_store_faults,
                         sp.borrow_coalesced),
        "router": (srv.router.rebalanced,
                   dict(srv.router.batches_per_shard),
                   srv.router.borrowed_pages),
        "failovers": (s.failovers, sp.failovers, sorted(sp.dead)),
    }


def _same_logits(a_list, b_list, tol=LOGIT_TOL):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


# ---------------------------------------------------- placement invariants --
def _random_sharers(rng, num_pages, num_models):
    models = [f"m{i}" for i in range(num_models)]
    out = {}
    for p in range(num_pages):
        k = int(rng.integers(1, num_models + 1))
        out[p] = frozenset(rng.choice(models, size=k, replace=False))
    return out


def _same_placement(a, b):
    assert (a.num_shards, a.policy, a.owners, a.owned_sets, a.replicated,
            a.pack_generation) == (b.num_shards, b.policy, b.owners,
                                   b.owned_sets, b.replicated,
                                   b.pack_generation)


@pytest.mark.parametrize("policy", PLACEMENTS)
def test_placement_total_deterministic_and_equal_to_the_reference(policy):
    """Both policies: total, deterministic, owned sets the inverse of the
    owners, and the reference's assignment exactly, across random sharing
    structures."""
    rng = np.random.default_rng(0)
    for _ in range(25):
        num_pages = int(rng.integers(1, 60))
        num_shards = int(rng.integers(1, 6))
        sharers = _random_sharers(rng, num_pages, int(rng.integers(1, 7)))
        budget = int(rng.integers(0, num_pages + 1))
        if policy == "hash":
            a = hash_placement(num_pages, num_shards)
            ref = jhash_placement(num_pages, num_shards)
        else:
            a = sharers_placement(num_pages, num_shards, sharers, budget)
            ref = jsharers_placement(num_pages, num_shards, sharers, budget)
        _same_placement(a, ref)
        assert len(a.owners) == num_pages
        for pid, owners in enumerate(a.owners):
            assert owners and all(0 <= s < num_shards for s in owners)
            assert sorted(set(owners)) == list(owners)
        for s in range(num_shards):
            assert a.owned_sets[s] == frozenset(
                p for p in range(num_pages) if s in a.owners[p])
        if policy == "hash":
            assert not a.replicated


@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=1, max_value=5),
       st.integers(min_value=0, max_value=64),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
@settings(max_examples=40, deadline=None)
def test_sharers_placement_property_equals_the_reference(num_pages,
                                                         num_shards, budget,
                                                         seed):
    """The replicated set stays within the budget and holds only pages of
    >= 2 sharers, each on every shard; the whole assignment is the
    reference's."""
    rng = np.random.default_rng(seed)
    sharers = _random_sharers(rng, num_pages, 4)
    pl = sharers_placement(num_pages, num_shards, sharers, budget)
    _same_placement(pl, jsharers_placement(num_pages, num_shards, sharers,
                                           budget))
    assert len(pl.replicated) <= budget
    for p in pl.replicated:
        assert len(sharers[p]) >= 2
        assert pl.owners[p] == tuple(range(num_shards))


def test_make_placement_on_one_store_equals_the_reference(jax_db):
    """On the store the reference wrote: both policies give the
    reference's placement, keyed on the pack generation."""
    jstore, store = _open_both(jax_db(1024, 4))
    for policy in PLACEMENTS:
        for shards in (1, 2, 4):
            a = make_placement(policy, store, shards)
            assert a.pack_generation == store.pack_generation
            _same_placement(a, jmake_placement(policy, jstore, shards))
            assert make_placement(policy, store, shards).owners == a.owners


def test_unknown_placement_rejected(jax_db):
    _, store = _open_both(jax_db(1024, 4))
    with pytest.raises(ValueError):
        make_placement("roulette", store, 2)
    with pytest.raises(ValueError):
        ShardedWeightServer(store, 4, shards=2, placement="roulette",
                            kernel_mode="torch")
    with pytest.raises(ValueError):
        ShardedWeightServer(store, 4, shards=2, transfer="teleport",
                            kernel_mode="torch")


# ---------------------------------------------------------------- routing --
def test_router_choices_and_splits_equal_the_reference(jax_db):
    """Majority cover wins, ties go to the lowest shard, and every route
    and split on the same pages is the reference router's, counters
    included."""
    jstore, store = _open_both(jax_db(1024, 4))
    for policy in PLACEMENTS:
        srv = ShardedWeightServer(store, store.num_pages(),
                                  storage=StorageModel("dram"), shards=2,
                                  placement=policy, kernel_mode="torch")
        jsrv = JSharded(jstore, jstore.num_pages(), storage=JStorage("dram"),
                        shards=2, placement=policy, kernel_mode="host")
        router = ShardRouter(srv.sharded.placement)
        jrouter = JRouter(jsrv.sharded.placement)
        pl = srv.sharded.placement()
        rng = np.random.default_rng(3)
        sets = [sorted(pl.owned_sets[0])[:3] + sorted(pl.owned_sets[1])[:1],
                sorted(pl.owned_sets[0])[:1] + sorted(pl.owned_sets[1])[:1]]
        sets += [list(rng.choice(store.num_pages(), size=int(k),
                                 replace=False))
                 for k in rng.integers(1, store.num_pages(), size=20)]
        for pages in sets:
            r, jr = router.route(pages), jrouter.route(pages)
            assert (r.shard, r.owned, r.borrowed, r.pack_generation) == \
                (jr.shard, jr.owned, jr.borrowed, jr.pack_generation)
            for s in range(2):
                assert router.split(pages, s) == jrouter.split(pages, s)
        assert router.batches_per_shard == jrouter.batches_per_shard
        assert router.borrowed_pages == jrouter.borrowed_pages
        assert router.rebalanced == jrouter.rebalanced
        if policy == "hash":
            r = router.route(sets[0])
            assert r.shard == 0 and set(r.borrowed) == set(sets[0][3:])


def test_submit_shard_annotation_matches_runtime_routing(jax_db):
    """The advisory ``ScheduledBatch.shard`` set at submit() is the shard
    the server routes to at run time, as in the reference; after a repack
    the server routes under the new placement."""
    url = jax_db(1024, 3)
    _, store = _open_both(url)
    task, heads = _heads(1024, 3)
    srv = ShardedWeightServer(store, max(4, store.num_pages() // 2),
                              storage=StorageModel("dram"), shards=2,
                              placement="sharers", balance_replicas=False,
                              kernel_mode="torch")
    engine = EmbeddingServingEngine(srv, heads)
    for b in range(6):
        v = b % 3
        docs, _ = task.sample(16, variant=v, seed=700 + b)
        engine.submit(f"word2vec-v{v}", docs)
    for batch in engine.scheduler.pending_batches():
        assert batch.shard is not None
    while engine.scheduler.pending():
        batch = engine.scheduler.next_batch(srv.pool.resident_pages())
        advisory = batch.shard
        engine._infer(batch)
        assert srv._route.shard == advisory
    docs, _ = task.sample(16, variant=0, seed=777)
    engine.submit("word2vec-v0", docs)
    store.update("word2vec-v0",
                 {"embedding": task.variant_embedding(0) + 0.25})
    engine.run(max_batches=1)
    assert srv._route.pack_generation == store.pack_generation
    srv.sharded.check_invariants()


# ------------------------------------------------------------- equivalence --
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("port_mode,ref_mode", [("torch", "pallas"),
                                                ("host", "host")])
def test_sharded_embedding_matches_the_reference(jax_db, shards, port_mode,
                                                 ref_mode):
    """Sharded logits within 1e-5 of the reference's sharded run, of the
    port's single slab and of its numpy path, at 1/2/4 shards under both
    placements; per-shard pool decisions, routes and borrow counters equal
    to the reference's exactly."""
    small = ref_mode == "pallas"
    vocab = 256 if small else 1024
    url = jax_db(vocab, 3)
    task, heads = _heads(vocab, 3)
    traffic = _docs(task, 3, 4 if small else 8, 8 if small else 16)
    jstore, store = _open_both(url)
    cap = max(4, store.num_pages() // max(2, shards) + 2)
    numpy = _run(EmbeddingServingEngine(WeightServer(
        store, store.num_pages(), storage=StorageModel("dram"),
        backend="numpy"), heads), traffic)
    single = _run(EmbeddingServingEngine(WeightServer(
        store, store.num_pages(), storage=StorageModel("dram"),
        kernel_mode=port_mode), heads), traffic)
    for placement in PLACEMENTS:
        srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                                  shards=shards, placement=placement,
                                  kernel_mode=port_mode)
        engine = EmbeddingServingEngine(srv, heads)
        got = _run(engine, traffic)
        jsrv = JSharded(jstore, cap, storage=JStorage("dram"), shards=shards,
                        placement=placement, kernel_mode=ref_mode)
        jengine = JEngine(jsrv, heads)
        want = _run(jengine, traffic)
        _same_logits(got, want)
        _same_logits(got, single)
        _same_logits(got, numpy)
        assert _decisions(srv) == _decisions(jsrv)
        # a batch whose pages outgrow one shard's slab is served on the
        # host in the CPU modes, as in the reference (cuda mode raises)
        assert (engine.stats.device_batches, engine.stats.dense_fallbacks) \
            == (jengine.stats.device_batches, jengine.stats.dense_fallbacks)
        srv.sharded.check_invariants()
        jsrv.sharded.check_invariants()


class _TinyApi:
    """The reference test's linear 'LM' in torch: prefill and decode are
    matmuls against the faulted tensors, so a wrong page shows in the
    tokens at once."""

    def prefill(self, params, batch, _):
        x = batch["tokens"].float()
        h = x @ params["embed"][:x.shape[-1]]
        return (h @ params["b"][:, :h.shape[-1]].T)[:, None, :], h

    def decode(self, params, cache, toks):
        h = cache + toks.float().mean()
        return (h @ params["b"][:, :h.shape[-1]].T)[:, None, :], h


class _JTinyApi:
    def prefill(self, params, batch, _):
        x = np.asarray(batch["tokens"], np.float32)
        h = x @ params["w"][:x.shape[-1]]
        return (h @ params["b"][:, :h.shape[-1]].T)[:, None, :], h

    def decode(self, params, cache, toks):
        h = cache + np.asarray(toks, np.float32).mean()
        return (h @ params["b"][:, :h.shape[-1]].T)[:, None, :], h


def _lm_stores():
    cfg = dict(block_shape=(16, 16), validate=False)
    rng = np.random.default_rng(0)
    base = rng.standard_normal((48, 32)).astype(np.float32)
    tensors = {f"lm-v{v}": {"w": base + v * 1e-5,
                            "b": base[:16] * 0.5 + v * 1e-5}
               for v in range(2)}
    from repro.core import DedupConfig as JDedupConfig
    from repro.core import LSHConfig as JLSHConfig
    from repro.core import StoreConfig as JStoreConfig
    lsh = dict(num_bands=8, rows_per_band=2, r=8.0, collision_threshold=6)
    store = ModelStore(StoreConfig(dedup=DedupConfig(lsh=LSHConfig(**lsh),
                                                     **cfg),
                                   blocks_per_page=4))
    jstore = JModelStore(JStoreConfig(dedup=JDedupConfig(
        lsh=JLSHConfig(**lsh), **cfg), blocks_per_page=4))
    for name, ts in tensors.items():
        store.register(name, ts)
        jstore.register(name, ts)
    prompts = rng.standard_normal((2, 48)).astype(np.float32)
    return store, jstore, prompts


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_lm_tokens_equal_the_reference(shards):
    """LM ``generate`` through a sharded server: the reference's tokens
    (its sharded run in Pallas interpret mode) exactly, and the port's
    numpy and single-slab tokens, under both placements."""
    store, jstore, prompts = _lm_stores()
    models = ("lm-v0", "lm-v1", "lm-v0")

    def rebuild(ts, device=None):
        return {"embed": torch.as_tensor(np.asarray(ts["w"])).to(device),
                "b": torch.as_tensor(np.asarray(ts["b"])).to(device)}

    def generate(server):
        engine = LMServingEngine(server, {m: _TinyApi() for m in models},
                                 {m: {"rebuild": rebuild} for m in models})
        return [engine.generate(m, prompts, steps=3)[0] for m in models], \
            engine.stats

    def jgenerate(server):
        engine = JLMEngine(server, {m: _JTinyApi() for m in models},
                           {m: {"rebuild": lambda ts: {
                               k: np.asarray(v) for k, v in ts.items()}}
                            for m in models})
        return [engine.generate(m, prompts, steps=3)[0] for m in models]

    numpy, _ = generate(WeightServer(store, store.num_pages(),
                                     storage=StorageModel("dram"),
                                     backend="numpy"))
    single, sstats = generate(WeightServer(store, store.num_pages(),
                                           storage=StorageModel("dram"),
                                           kernel_mode="torch"))
    assert sstats.dense_fallbacks == 0
    cap = max(4, store.num_pages() // max(2, shards) + 2)
    for placement in PLACEMENTS:
        srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                                  shards=shards, placement=placement,
                                  kernel_mode="torch")
        got, stats = generate(srv)
        jsrv = JSharded(jstore, cap, storage=JStorage("dram"), shards=shards,
                        placement=placement, kernel_mode="pallas")
        want = jgenerate(jsrv)
        for a, b, c, d in zip(got, want, numpy, single):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(a, d)
        assert stats.dense_fallbacks == 0
        assert _decisions(srv) == _decisions(jsrv)
        srv.sharded.check_invariants()


def test_single_shard_identical_to_device_backend(jax_db):
    """shards=1 is the identity: the single-slab server's bits, pool
    decisions and slab loads, zero borrows; the reference's decisions."""
    url = jax_db(1024, 4)
    task, heads = _heads(1024, 4)
    traffic = _docs(task, 4, 10, 16)
    jstore, store = _open_both(url)
    cap = max(4, store.num_pages() // 2)
    base = WeightServer(store, cap, storage=StorageModel("dram"),
                        kernel_mode="torch")
    bengine = EmbeddingServingEngine(base, heads)
    a = _run(bengine, traffic)
    srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                              shards=1, kernel_mode="torch")
    sengine = EmbeddingServingEngine(srv, heads)
    b = _run(sengine, traffic)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (base.pool.hits, base.pool.misses, base.pool.evictions) \
        == (srv.pool.hits, srv.pool.misses, srv.pool.evictions)
    assert base.device_pool.loads == srv.device_pool.loads
    assert base.device_pool.evicts == srv.device_pool.evicts
    assert srv.stats.borrow_pages == 0
    assert bengine.stats.device_batches == sengine.stats.device_batches
    jsrv = JSharded(jstore, cap, storage=JStorage("dram"), shards=1,
                    kernel_mode="host")
    _run(JEngine(jsrv, heads), traffic)
    assert _decisions(srv) == _decisions(jsrv)


# ------------------------------------------------------------ staging tail --
@pytest.mark.parametrize("kernel_mode", ["torch", "host"])
def test_staging_tail_lies_past_the_free_slots(jax_db, kernel_mode):
    """``stage_rows`` extends the slab as in the reference (its shape),
    the free slots cover ``capacity`` only, the kernel view spans the
    tail, and ``write_stage`` lands rows past ``capacity`` and refuses a
    slot outside the tail."""
    from repro.serving.device_pool import DevicePagePool as JPool
    from repro_torch.serving import DevicePagePool
    jstore, store = _open_both(jax_db(1024, 3))
    pool = DevicePagePool(store, 4, kernel_mode=kernel_mode, stage_rows=3)
    jpool = JPool(jstore, 4, kernel_mode="host", stage_rows=3)
    slab = pool.host_slab if kernel_mode == "host" else pool.slab
    assert tuple(slab.shape) == jpool.host_slab.shape
    assert sorted(pool._free) == sorted(jpool._free) == [0, 1, 2, 3]
    pages = np.stack([store.page_array(p) for p in (0, 1)])
    rows = pages if kernel_mode == "host" else torch.from_numpy(pages)
    pool.write_stage([2, 0], rows)
    np.testing.assert_array_equal(pool.slot_page(6), pages[0])
    np.testing.assert_array_equal(pool.slot_page(4), pages[1])
    assert pool.generation == 0 and not pool.slot_of
    if kernel_mode == "torch":
        assert pool.flat_pool().shape[0] == 7 * store.cfg.blocks_per_page
    with pytest.raises(IndexError):
        pool.write_stage([3], rows[:1])


# ------------------------------------------------------ borrows / invariant --
@pytest.mark.parametrize("kernel_mode", ["torch", "host"])
def test_borrow_protocol_counts_equal_the_reference(jax_db, kernel_mode):
    """hash placement scatters cover sets, so 2 shards must borrow: staged
    into the tail, never slab-resident on the borrower, batches on the
    device path; every count and staged slot is the reference's, and the
    tail holds the store's bytes."""
    url = jax_db(2048, 4)
    task, heads = _heads(2048, 4)
    traffic = _docs(task, 4, 8, 16)
    jstore, store = _open_both(url)
    srv = ShardedWeightServer(store, store.num_pages(),
                              storage=StorageModel("dram"), shards=2,
                              placement="hash", kernel_mode=kernel_mode)
    engine = EmbeddingServingEngine(srv, heads)
    got = _run(engine, traffic)
    jsrv = JSharded(jstore, jstore.num_pages(), storage=JStorage("dram"),
                    shards=2, placement="hash", kernel_mode="host")
    want = _run(JEngine(jsrv, heads), traffic)
    _same_logits(got, want)
    assert srv.stats.borrow_pages > 0
    assert engine.stats.device_batches == len(traffic)
    assert srv.stats.borrow_seconds == jsrv.stats.borrow_seconds > 0.0
    assert srv.stats.borrow_mirror_hits + srv.stats.borrow_store_faults \
        == srv.stats.borrow_pages
    assert sum(srv.stats.shard_batches.values()) == len(traffic)
    assert srv.sharded.tail_reads["gather_rows"] > 0
    assert _decisions(srv) == _decisions(jsrv)
    srv.sharded.check_invariants()
    for s, pool in enumerate(srv.sharded.pools):
        for pid, slot in srv.sharded.staged(s).items():
            np.testing.assert_array_equal(
                pool.slot_page(pool.capacity + slot), store.page_array(pid))


@pytest.mark.parametrize("kernel_mode", ["torch", "host"])
def test_stage_borrows_survives_owner_thrash_as_the_reference(jax_db,
                                                              kernel_mode):
    """A borrow set larger than the owner's pool still stages: owner-side
    faults evict each other (capacity 1) and pages evicted between fault
    and copy come from the store; the slots and counts are the
    reference's, the tail holds the store's bytes."""
    jstore, store = _open_both(jax_db(1024, 3))
    pool = ShardedPagePool(store, 2, capacity_per_shard=1, placement="hash",
                           borrow_capacity=8, kernel_mode=kernel_mode)
    jpool = JShardedPool(jstore, 2, capacity_per_shard=1, placement="hash",
                         borrow_capacity=8, kernel_mode="host")
    odd = [p for p in range(store.num_pages()) if p % 2 == 1][:3]
    pool.buffer_pools[1].access("word2vec-v0", odd[0])
    jpool.buffer_pools[1].access("word2vec-v0", odd[0])
    res = pool.stage_borrows(0, odd, "word2vec-v0")
    assert res == jpool.stage_borrows(0, odd, "word2vec-v0")
    staged, hits, faults, reused = res
    assert set(staged) == set(odd) and hits + faults == len(odd)
    tail = pool.pools[0]
    for pid in odd:
        np.testing.assert_array_equal(
            tail.slot_page(tail.capacity + staged[pid]),
            store.page_array(pid))
    pool.check_invariants()


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_per_shard_residency_invariant_under_churn(jax_db, placement):
    """Random access/prefetch churn: each shard's slab equals its pool's
    resident set, no page sits on a shard its placement did not assign,
    the slab bytes are the store's, and every shard's resident set after
    every step is the reference's."""
    jstore, store = _open_both(jax_db(1024, 4))
    cap = max(2, store.num_pages() // 3)
    srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                              shards=3, placement=placement,
                              kernel_mode="torch")
    jsrv = JSharded(jstore, cap, storage=JStorage("dram"), shards=3,
                    placement=placement, kernel_mode="host")
    pl = srv.sharded.placement()
    rng = np.random.default_rng(0)
    models = sorted(store.dedup.models)
    for _ in range(250):
        m = models[int(rng.integers(len(models)))]
        p = int(rng.integers(store.num_pages()))
        if rng.random() < 0.25:
            assert srv.pool.prefetch(m, p) == jsrv.pool.prefetch(m, p)
        else:
            s = pl.shards_of(p)[0]
            assert srv.sharded.buffer_pools[s].access(m, p) == \
                jsrv.sharded.buffer_pools[s].access(m, p)
        srv.sharded.check_invariants()
        assert [sorted(d.slot_of.items()) for d in srv.sharded.pools] == \
            [sorted(d.slot_of.items()) for d in jsrv.sharded.pools]
    for dev in srv.sharded.pools:
        for pid, slot in dev.slot_of.items():
            np.testing.assert_array_equal(dev.slot_page(slot),
                                          store.page_array(pid))


def test_on_load_rejects_non_owner(jax_db):
    _, store = _open_both(jax_db(1024, 4))
    srv = ShardedWeightServer(store, store.num_pages(),
                              storage=StorageModel("dram"), shards=2,
                              placement="hash", kernel_mode="torch")
    pl = srv.sharded.placement()
    victim = next(p for p in range(store.num_pages())
                  if pl.shards_of(p) == (1,))
    with pytest.raises(RuntimeError, match="placement invariant"):
        srv.sharded.buffer_pools[0].access("m", victim)


# ------------------------------------------------------- update / repack --
def test_update_repack_keeps_replicated_pages_consistent(jax_db):
    """After an update() repack the placement is rebuilt (the reference's
    again), every replicated page resident on both shards holds the new
    packing's bytes, and the logits follow the updated weights (1e-5)."""
    url = jax_db(1024, 3)
    task, heads = _heads(1024, 3)
    jstore, store = _open_both(url)
    srv = ShardedWeightServer(store, store.num_pages(),
                              storage=StorageModel("dram"), shards=2,
                              placement="sharers", kernel_mode="torch")
    jsrv = JSharded(jstore, jstore.num_pages(), storage=JStorage("dram"),
                    shards=2, placement="sharers", kernel_mode="host")
    engine, jengine = EmbeddingServingEngine(srv, heads), JEngine(jsrv, heads)
    _run(engine, _docs(task, 3, 6, 16))
    _run(jengine, _docs(task, 3, 6, 16))
    gen0, pl0 = store.pack_generation, srv.sharded.placement()
    new = {"embedding": task.variant_embedding(0) + 0.25}
    store.update("word2vec-v0", new)
    jstore.update("word2vec-v0", new)
    _same_logits(_run(engine, _docs(task, 3, 6, 16, seed=50)),
                 _run(jengine, _docs(task, 3, 6, 16, seed=50)))
    assert store.pack_generation > gen0
    pl1 = srv.sharded.placement()
    assert pl1.pack_generation == store.pack_generation \
        != pl0.pack_generation
    _same_placement(pl1, jsrv.sharded.placement())
    assert _decisions(srv) == _decisions(jsrv)
    assert pl1.replicated, "scenario produced no shared pages to replicate"
    for pid in sorted(pl1.replicated)[:4]:
        for s in range(srv.num_shards):
            srv.sharded.buffer_pools[s].access("word2vec-v0", pid)
        for dev in srv.sharded.pools:
            np.testing.assert_array_equal(dev.slot_page(dev.slot_of[pid]),
                                          store.page_array(pid))
    srv.sharded.check_invariants()
    docs, _ = task.sample(16, variant=0, seed=999)
    engine.submit("word2vec-v0", docs)
    engine.run(max_batches=1)
    emb = store.materialize("word2vec-v0", "embedding")
    np.testing.assert_allclose(engine.last_logits,
                               emb[docs].mean(axis=1) @ heads["word2vec-v0"],
                               atol=LOGIT_TOL)


def test_update_between_submit_and_run_cannot_fault_stale_pages(jax_db):
    """A model update between submit() and run(): the batch recomputes its
    pages and route under the new placement on every shard."""
    url = jax_db(1024, 3)
    task, heads = _heads(1024, 3)
    _, store = _open_both(url)
    srv = ShardedWeightServer(store, max(4, store.num_pages() // 2),
                              storage=StorageModel("dram"), shards=2,
                              placement="sharers", kernel_mode="torch")
    engine = EmbeddingServingEngine(srv, heads)
    _run(engine, _docs(task, 3, 3, 16))
    docs, _ = task.sample(16, variant=0, seed=321)
    engine.submit("word2vec-v0", docs)
    store.update("word2vec-v0",
                 {"embedding": task.variant_embedding(0) + 0.125})
    engine.run(max_batches=1)
    srv.sharded.check_invariants()
    emb = store.materialize("word2vec-v0", "embedding")
    np.testing.assert_allclose(engine.last_logits,
                               emb[docs].mean(axis=1) @ heads["word2vec-v0"],
                               atol=LOGIT_TOL)


# -------------------------------------------------------------- mesh slab --
def test_stacked_slab_equals_the_reference(jax_db):
    """``stacked_slab()`` is the shards' resident rows, [S, cap, l, bh,
    bw], equal to the reference's (Pallas mode) bit for bit; None in host
    mode (the mesh view: the next test)."""
    jstore, store = _open_both(jax_db(1024, 4))
    srv = ShardedWeightServer(store, 4, storage=StorageModel("dram"),
                              shards=2, placement="sharers",
                              kernel_mode="torch")
    jsrv = JSharded(jstore, 4, storage=JStorage("dram"), shards=2,
                    placement="sharers", kernel_mode="pallas")
    pl = srv.sharded.placement()
    for s in range(2):
        for pid in sorted(pl.owned_sets[s])[:2]:
            srv.sharded.buffer_pools[s].access("word2vec-v0", pid)
            jsrv.sharded.buffer_pools[s].access("word2vec-v0", pid)
    slab = srv.sharded.stacked_slab()
    assert tuple(slab.shape[:2]) == (2, 4)
    np.testing.assert_array_equal(slab.numpy(),
                                  np.asarray(jsrv.sharded.stacked_slab()))
    for s, dev in enumerate(srv.sharded.pools):
        for pid, slot in dev.slot_of.items():
            np.testing.assert_array_equal(slab[s, slot].numpy(),
                                          store.page_array(pid))
    host = ShardedWeightServer(store, 4, storage=StorageModel("dram"),
                               shards=2, kernel_mode="host")
    assert host.sharded.stacked_slab() is None


def test_stacked_slab_lowers_with_named_sharding(jax_db):
    """Port of the reference's mesh view: the per-shard slabs stack to
    [S, cap, l, bh, bw] and lay out over the serving mesh's shard axis
    (``slab_spec``, sanitized) as a DTensor -- on the CPU a one-rank gloo
    mesh, whose local tensor is the whole stack, bit-equal to the
    reference's slab; the process group is torn down after."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_shard_mesh
    jstore, store = _open_both(jax_db(1024, 4))
    srv = ShardedWeightServer(store, 4, storage=StorageModel("dram"),
                              shards=2, placement="sharers",
                              kernel_mode="torch")
    jsrv = JSharded(jstore, 4, storage=JStorage("dram"), shards=2,
                    placement="sharers", kernel_mode="pallas")
    pl = srv.sharded.placement()
    for s in range(2):
        for pid in sorted(pl.owned_sets[s])[:2]:
            srv.sharded.buffer_pools[s].access("word2vec-v0", pid)
            jsrv.sharded.buffer_pools[s].access("word2vec-v0", pid)
    try:
        mesh = make_shard_mesh(2, kernel_mode="torch")
        assert mesh.mesh_dim_names == ("shard",) and mesh.size() == 1
        slab = srv.sharded.stacked_slab(mesh)
        assert isinstance(slab, DTensor)
        assert tuple(slab.shape[:2]) == (2, 4)
        assert tuple(slab.placements) == (Shard(0),)
        np.testing.assert_array_equal(
            slab.to_local().numpy(), np.asarray(jsrv.sharded.stacked_slab()))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the CPU-only rule --
def test_cuda_and_auto_modes_refuse_without_a_card(jax_db):
    """No silent CPU fallback: with no card, ``auto`` raises, as the
    single slab does.  The CPU modes keep the reference's host fallback
    for a borrow set the tail cannot hold."""
    url = jax_db(2048, 4)
    _, store = _open_both(url)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedWeightServer(store, 4, shards=2)
    task, heads = _heads(2048, 4)
    srv = ShardedWeightServer(store, store.num_pages(),
                              storage=StorageModel("dram"), shards=2,
                              placement="hash", borrow_capacity=1,
                              kernel_mode="torch")
    engine = EmbeddingServingEngine(srv, heads)
    got = _run(engine, _docs(task, 4, 4, 16))
    assert engine.stats.dense_fallbacks > 0           # the host served them
    for (model, docs), logits in zip(_docs(task, 4, 4, 16), got):
        emb = store.materialize(model, "embedding")
        np.testing.assert_allclose(logits, emb[docs].mean(axis=1)
                                   @ heads[model], atol=LOGIT_TOL)


# -------------------------------------------- ports from test_transfer.py --
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_grouped_matches_per_page_sharded(jax_db, shards):
    """Sharded serving through grouped per-shard transfers == per_page ==
    the numpy path (1e-5), at 1/2/4 shards in torch mode, with the
    reference's pool decisions and borrow counters for each transfer
    mode."""
    url = jax_db(1024, 4)
    task, heads = _heads(1024, 4)
    traffic = _docs(task, 4, 8, 16)
    jstore, store = _open_both(url)
    cap = max(4, store.num_pages() - 2)
    ref = _run(EmbeddingServingEngine(WeightServer(
        store, cap, storage=StorageModel("dram"), backend="numpy"), heads),
        traffic)
    out = {}
    for transfer in ("per_page", "grouped"):
        srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                                  shards=shards, placement="sharers",
                                  transfer=transfer, kernel_mode="torch")
        out[transfer] = _run(EmbeddingServingEngine(srv, heads), traffic)
        srv.sharded.check_invariants()
        jsrv = JSharded(jstore, cap, storage=JStorage("dram"), shards=shards,
                        placement="sharers", transfer=transfer,
                        kernel_mode="host")
        _run(JEngine(jsrv, heads), traffic)
        assert _decisions(srv) == _decisions(jsrv)
    _same_logits(ref, out["per_page"])
    _same_logits(ref, out["grouped"])


# ----------------------------------------------- port from test_faults.py --
def _chaos_spec(spec_cls, rate, seed=11):
    return spec_cls(transient=rate, corrupt=rate, lock=rate, torn=rate,
                    latency=min(1.0, 2 * rate), seed=seed)


def _faults_scenario(batches=8, batch=32):
    """The reference's chaos scenario: 3 variants, vocab 512, the
    all-miss capacity, committed to a MemoryBackend in each package."""
    jtask = JTask(vocab=512, d=32, seed=0)
    jstore, heads = jbuild_store(jtask, num_models=3, block_shape=(32, 32),
                                 blocks_per_page=4)
    rng = np.random.default_rng(0)
    traffic = []
    for b in range(batches):
        v = int(rng.integers(0, 3))
        docs, _ = jtask.sample(batch, variant=v, seed=7_000 + b)
        traffic.append((f"word2vec-v{v}", docs))
    probe = JServer(jstore, 2)
    worst = max(len(probe.embedding_rows_pages(m, "embedding",
                                               np.unique(d)))
                for m, d in traffic)
    cap = min(jstore.num_pages(), worst + 1)
    jinner = JMemoryBackend()
    jstore.save(jinner)
    task = SyntheticTextTask(vocab=512, d=32, seed=0)
    store, pheads = build_store(task, num_models=3, block_shape=(32, 32),
                                blocks_per_page=4, index_mode="host")
    for m in heads:
        np.testing.assert_array_equal(heads[m], pheads[m])
    inner = MemoryBackend()
    store.save(inner)
    return heads, traffic, cap, inner, jinner


def _serve_failover(server_cls, engine_cls, store, heads, traffic, cap,
                    **kw):
    server = server_cls(store, cap, storage=(StorageModel if server_cls is
                                             ShardedWeightServer else
                                             JStorage)("dram"),
                        shards=2, placement="sharers", **kw)
    engine = engine_cls(server, heads, scheduler="fifo", overlap=True)
    logits = []
    for i, (model, docs) in enumerate(traffic):
        if i == 3:
            server.fail_shard(0)
        if i == 6:
            server.revive_shard(0)
        engine.submit(model, docs)
        engine.run(max_batches=1)
        logits.append(np.asarray(engine.last_logits, np.float32))
    return np.concatenate([l.reshape(-1) for l in logits]), server


@pytest.mark.parametrize("kernel_mode", ["torch", "host"])
def test_chaos_embedding_two_shards_with_midrun_failover(kernel_mode):
    """2 shards, shard 0 failed mid-run and revived later, at 10%
    injection: logits bit-equal to the same sharded run without faults,
    within 1e-5 of the reference's failover run, failover and borrow
    accounting equal to the reference's, the injected faults the same."""
    heads, traffic, cap, inner, jinner = _faults_scenario()
    kw = dict(kernel_mode=kernel_mode)
    clean, ref_srv = _serve_failover(ShardedWeightServer,
                                     EmbeddingServingEngine,
                                     ModelStore.open(inner), heads, traffic,
                                     cap, **kw)
    fb = FaultInjectingBackend(inner, _chaos_spec(FaultSpec, 0.10))
    chaos, srv = _serve_failover(ShardedWeightServer, EmbeddingServingEngine,
                                 ModelStore.open(fb), heads, traffic, cap,
                                 **kw)
    np.testing.assert_array_equal(clean, chaos)
    assert sum(fb.injected.values()) > 0
    assert srv.stats.failovers == ref_srv.stats.failovers == 1
    srv.sharded.check_invariants()
    jfb = JFaulty(jinner, _chaos_spec(JFaultSpec, 0.10))
    jchaos, jsrv = _serve_failover(JSharded, JEngine, JModelStore.open(jfb),
                                   heads, traffic, cap, kernel_mode="host")
    np.testing.assert_allclose(chaos, jchaos, atol=LOGIT_TOL, rtol=0)
    assert fb.injected == jfb.injected
    assert _decisions(srv) == _decisions(jsrv)
    assert srv.stats.borrow_store_faults > 0      # orphans came from store
