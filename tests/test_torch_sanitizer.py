"""The port's PoolSanitizer on the port's pools, on the CPU.

``repro_torch.analysis.sanitizer`` is a verbatim copy of the reference's
(``tests/test_torch_isolation.py``), so these are the scenarios of
``tests/test_sanitizer.py`` run against the port's ``BufferPool``,
``DevicePagePool`` and ``ShardedPagePool`` in the ``torch`` and ``host``
kernel modes: each protocol violation, injected deliberately, raises
``PoolSanitizerError`` at the violating call, and the clean flows stay
silent.  The buffer-pool scenarios drive a device pool of the mode
through the buffer pool's callbacks.  The clean serving flow's event
history also equals the reference sanitizer's on the reference's pools.
The ``cuda`` mode is checked on the card by ``chip_smoke.py``.

Injection pattern: break the instance FIRST (bypass or corrupt the
production method), attach the sanitizer SECOND, trigger THIRD.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizer import (PoolSanitizer, PoolSanitizerError,
                                            disable, enable, enabled)
from repro_torch.core.bufferpool import BufferPool, PoolConfig
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import build_store
from repro_torch.serving.device_pool import DevicePagePool
from repro_torch.serving.engine import (EmbeddingServingEngine, StorageModel,
                                        WeightServer)
from repro_torch.serving.shard_pool import ShardedPagePool

torch.set_num_threads(2)

MODES = ["torch", "host"]


@pytest.fixture(params=MODES)
def mode(request):
    return request.param


def _store(num_models=3, l=4):
    # vocab=1024 -> ~10 pages: enough for group loads and a borrow tail
    task = SyntheticTextTask(vocab=1024, d=32, seed=0)
    store, heads = build_store(task, num_models=num_models,
                               block_shape=(32, 32), blocks_per_page=l,
                               index_mode="torch")
    return task, store, heads


def _pool(store, mode, capacity=None):
    return DevicePagePool(store, capacity or store.num_pages(),
                          kernel_mode=mode)


def _server(store, mode, **kw):
    return WeightServer(store, store.num_pages(),
                        storage=StorageModel("dram"), backend="device",
                        kernel_mode=mode, **kw)


def _sharded(store, mode, **kw):
    return ShardedPagePool(store, 2, capacity_per_shard=store.num_pages(),
                           placement="hash", kernel_mode=mode, **kw)


def _serve(task, server, heads, batches=4, engine=EmbeddingServingEngine):
    engine = engine(server, heads)
    for b in range(batches):
        docs, _ = task.sample(8, variant=b % 3, seed=b)
        engine.submit(f"word2vec-v{b % 3}", docs)
        engine.run(max_batches=1)
    return engine


# ------------------------------------------------------------ clean flows --
def test_clean_serving_flow_is_silent(mode):
    """Full engine loop under instrumentation: no violations."""
    task, store, heads = _store()
    san = PoolSanitizer(strict=True)
    server = _server(store, mode, transfer="grouped")
    san.attach_device_pool(server.device_pool)
    san.attach_buffer_pool(server.pool)
    _serve(task, server, heads)
    assert san.violations == []
    assert len(san.events) > 0
    assert "0 violations" in san.report()


def _instrument(san, server):
    """Attach by instance, and point the buffer pool's callbacks (bound
    when the server was built) at the wrapped device-pool methods, so the
    history holds the engine's loads and evictions too."""
    pool, bp = server.device_pool, server.pool
    san.attach_device_pool(pool)
    san.attach_buffer_pool(bp)
    bp.on_load, bp.on_evict = pool.load, pool.evict
    bp.on_load_group = pool.load_group


def test_clean_flow_events_equal_the_reference(mode):
    """The same 4 batches through the reference's pools (host mode) under
    the reference's sanitizer record the same event history: the port's
    pools load, evict, remap and read in the same order, at the same
    slots and generations."""
    from repro.analysis.sanitizer import PoolSanitizer as JSanitizer
    from repro.data.pipeline import SyntheticTextTask as JTask
    from repro.launch.serve import build_store as jbuild_store
    from repro.serving.engine import EmbeddingServingEngine as JEngine
    from repro.serving.engine import StorageModel as JStorage
    from repro.serving.engine import WeightServer as JServer

    def history(san):
        return [(e.op, e.role, e.shard, e.page, e.slot, e.generation)
                for e in san.events]

    task, store, heads = _store()
    # one variant's pages fit, a switch evicts: every batch on the device
    cap = max(len(store.model_pages(m)) for m in heads)
    san = PoolSanitizer(strict=True)
    server = WeightServer(store, cap, storage=StorageModel("dram"),
                          backend="device", kernel_mode=mode,
                          transfer="grouped")
    _instrument(san, server)
    _serve(task, server, heads, batches=6)

    jtask = JTask(vocab=1024, d=32, seed=0)
    jstore, jheads = jbuild_store(jtask, num_models=3, block_shape=(32, 32),
                                  blocks_per_page=4)
    jsan = JSanitizer(strict=True)
    jserver = JServer(jstore, cap, storage=JStorage("dram"),
                      backend="device", transfer="grouped",
                      kernel_mode="host")
    _instrument(jsan, jserver)
    _serve(jtask, jserver, jheads, batches=6, engine=JEngine)
    ops = {e[0] for e in history(san)}
    assert {"load_group", "evict", "bp_evict", "remap",
            "gather_rows"} <= ops, ops
    assert history(san) == history(jsan)
    assert san.violations == jsan.violations == []


def test_clean_update_flush_reload_is_silent(mode):
    """Model update -> repack -> flush -> reload: the invalidation path
    is exactly what the sanitizer watches; it must not false-positive."""
    task, store, heads = _store()
    san = PoolSanitizer(strict=True)
    server = _server(store, mode)
    san.attach_device_pool(server.device_pool)
    san.attach_buffer_pool(server.pool)
    engine = EmbeddingServingEngine(server, heads)
    docs, _ = task.sample(8, variant=0, seed=1)
    engine.submit("word2vec-v0", docs)
    engine.run(max_batches=1)
    store.update("word2vec-v0", {"embedding":
                                 task.variant_embedding(0) + 0.5})
    engine.submit("word2vec-v0", docs)
    engine.run(max_batches=1)
    assert san.violations == []


# ------------------------------------------------------- injected: stale --
def test_stale_remap_read_detected(mode):
    """A dev_map minted before a load must not feed gather_rows after
    the slab generation moved on."""
    _, store, _ = _store()
    pool = _pool(store, mode, capacity=store.num_pages())
    vt = store.virtual_tensor("word2vec-v0", "embedding")
    for pid in vt.page_ids[:-1]:
        pool.load(pid)
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    stale_map = pool.remap(vt, strict=False)     # minted at gen g
    pool.load(vt.page_ids[-1])                   # gen bump -> map is stale
    with pytest.raises(PoolSanitizerError, match="stale-remap"):
        pool.gather_rows(stale_map, vt.grid, np.arange(4))


def test_fresh_remap_read_is_silent(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)
    vt = store.virtual_tensor("word2vec-v0", "embedding")
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    for pid in vt.page_ids:
        pool.load(pid)
    dev_map = pool.remap(vt)
    pool.gather_rows(dev_map, vt.grid, np.arange(4))
    assert san.violations == []


def test_cross_pool_remap_read_detected(mode):
    """A remap from pool A consumed by pool B is a wrong-shard read even
    if the generations happen to line up."""
    _, store, _ = _store()
    pool_a, pool_b = _pool(store, mode), _pool(store, mode)
    vt = store.virtual_tensor("word2vec-v0", "embedding")
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool_a)
    san.attach_device_pool(pool_b)
    for pid in vt.page_ids:
        pool_a.load(pid)
        pool_b.load(pid)
    map_a = pool_a.remap(vt)
    with pytest.raises(PoolSanitizerError, match="different pool"):
        pool_b.gather_rows(map_a, vt.grid, np.arange(4))


# ------------------------------------------- injected: generation bumps --
def test_missed_generation_bump_on_load_detected(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)

    def broken_load(pid):                        # admits without bumping
        slot = pool._free.pop()
        pool.slot_of[pid] = slot
        pool._page_to_slot[pid] = slot

    pool.load = broken_load
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="missed generation bump"):
        pool.load(0)


def test_missed_generation_bump_on_evict_detected(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)
    pool.load(0)

    def broken_evict(pid):                       # frees without bumping
        slot = pool.slot_of.pop(pid)
        pool._free.append(slot)
        pool._page_to_slot[pid] = -1

    pool.evict = broken_evict
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="missed generation bump"):
        pool.evict(0)


def test_group_load_multi_bump_detected(mode):
    """One grouped load = ONE generation bump."""
    _, store, _ = _store()
    pool = _pool(store, mode)

    def per_page_group(pids):                    # K bumps for one group
        for p in pids:
            DevicePagePool.load(pool, p)

    pool.load_group = per_page_group
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="one-group-one-bump"):
        pool.load_group([0, 1, 2])


def test_stage_must_not_bump_generation(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)

    orig_stage = pool.transfer.stage

    def bumping_stage(pids):
        out = orig_stage(pids)
        pool.generation += 1                     # staging leaked a bump
        return out

    pool.transfer.stage = bumping_stage
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="stage"):
        pool.transfer.stage([0, 1])


# ------------------------------------------------- injected: double-load --
def test_double_load_detected(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)
    pool.load(0)

    def readmitting_load(pid):                   # skips the residency check
        slot = pool._free.pop()
        pool.slot_of[pid] = slot
        pool._page_to_slot[pid] = slot
        pool.generation += 1

    pool.load = readmitting_load
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="double-load"):
        pool.load(0)


def test_slot_aliasing_detected(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)
    pool.load(0)

    def aliasing_load(pid):                      # reuses an occupied slot
        pool.slot_of[pid] = pool.slot_of[0]
        pool.generation += 1

    pool.load = aliasing_load
    san = PoolSanitizer(strict=True)
    san.attach_device_pool(pool)
    with pytest.raises(PoolSanitizerError, match="slot aliasing"):
        pool.load(1)


# ------------------------------------------ injected: evict-while-pinned --
def _device_backed(mode, capacity):
    """A buffer pool whose loads and evictions move pages of a device
    pool in ``mode``; both instrumented by one sanitizer."""
    _, store, _ = _store()
    pool = _pool(store, mode)
    bp = BufferPool(PoolConfig(capacity_pages=capacity),
                    on_load=pool.load, on_evict=pool.evict)
    return bp, pool


def test_evict_while_pinned_detected(mode):
    bp, pool = _device_backed(mode, 2)

    def pinned_blind_victim():                   # ignores the pinned set
        return next(iter(bp.resident))

    bp._pick_victim = pinned_blind_victim
    san = PoolSanitizer(strict=True)
    san.attach_buffer_pool(bp)
    san.attach_device_pool(pool)
    bp.access("m", 0)
    bp.access("m", 1)
    bp._pinned = {0, 1}                          # in-flight access_group
    with pytest.raises(PoolSanitizerError, match="evict-while-pinned"):
        bp.access("m", 2)


def test_clean_buffer_pool_churn_is_silent(mode):
    bp, pool = _device_backed(mode, 4)
    san = PoolSanitizer(strict=True)
    san.attach_buffer_pool(bp)
    san.attach_device_pool(pool)
    for i in range(64):
        bp.access("m", i % 9)
    assert san.violations == []
    assert sorted(pool.slot_of) == sorted(bp.resident)


# -------------------------------------------- injected: non-owner shard --
def test_non_owner_shard_load_detected(mode):
    _, store, _ = _store()
    sp = _sharded(store, mode)
    san = PoolSanitizer(strict=True)
    san.attach_sharded_pool(sp)
    pl = sp.placement()
    pid = next(p for p in range(store.num_pages())
               if 0 not in pl.shards_of(p))
    with pytest.raises(PoolSanitizerError, match="non-owner shard load"):
        sp.pools[0].load(pid)                    # bypasses _check_owner


def test_owner_shard_load_is_silent(mode):
    _, store, _ = _store()
    sp = _sharded(store, mode)
    san = PoolSanitizer(strict=True)
    san.attach_sharded_pool(sp)
    pl = sp.placement()
    pid = next(p for p in range(store.num_pages())
               if 0 in pl.shards_of(p))
    sp.pools[0].load(pid)
    assert san.violations == []


# ----------------------------------------- injected: borrow-slab aliasing --
def test_borrow_slab_aliasing_detected(mode):
    _, store, _ = _store()
    sp = _sharded(store, mode, borrow_capacity=8)
    pl = sp.placement()
    borrowed = [p for p in range(store.num_pages())
                if 0 not in pl.shards_of(p)][:2]
    assert len(borrowed) == 2

    orig = sp.stage_borrows

    def aliasing_stage(shard, pages, model):
        out = orig(shard, pages, model)
        st = sp._staged[shard]                   # corrupt: collapse slots
        first = next(iter(st.values()))
        for k in st:
            st[k] = first
        return out

    sp.stage_borrows = aliasing_stage
    san = PoolSanitizer(strict=True)
    san.attach_sharded_pool(sp)
    with pytest.raises(PoolSanitizerError, match="borrow-slab aliasing"):
        sp.stage_borrows(0, borrowed, "word2vec-v0")


def test_borrow_of_owned_page_detected(mode):
    _, store, _ = _store()
    sp = _sharded(store, mode, borrow_capacity=8)
    pl = sp.placement()
    owned = next(p for p in range(store.num_pages())
                 if 0 in pl.shards_of(p))

    orig = sp.stage_borrows

    def sneaky_stage(shard, pages, model):       # stages an owned page
        out = orig(shard, [p for p in pages if shard
                           not in pl.shards_of(p)], model)
        sp._staged[shard][owned] = 7
        return out

    sp.stage_borrows = sneaky_stage
    san = PoolSanitizer(strict=True)
    san.attach_sharded_pool(sp)
    with pytest.raises(PoolSanitizerError, match="owned by this shard"):
        sp.stage_borrows(0, [owned], "word2vec-v0")


# ------------------------------------------------------- non-strict mode --
def test_non_strict_mode_accumulates(mode):
    _, store, _ = _store()
    pool = _pool(store, mode)

    def broken_load(pid):
        slot = pool._free.pop()
        pool.slot_of[pid] = slot
        pool._page_to_slot[pid] = slot

    pool.load = broken_load
    san = PoolSanitizer(strict=False)
    san.attach_device_pool(pool)
    pool.load(0)
    pool.load(1)
    assert len(san.violations) >= 2
    assert "VIOLATION" in san.report()


# ------------------------------------------------------- global enable() --
def test_enable_instruments_new_pools(mode):
    was_on = enabled() is not None               # REPRO_SANITIZE=1 run
    if was_on:
        disable()
    san = enable(strict=True)
    try:
        assert enabled() is san
        assert enable() is san                   # idempotent
        _, store, _ = _store()
        pool = _pool(store, mode)
        assert getattr(pool, "_repro_sanitizer", None) is san
        bp = BufferPool(PoolConfig(capacity_pages=4))
        assert getattr(bp, "_repro_sanitizer", None) is san
        sp = _sharded(store, mode)
        assert getattr(sp, "_repro_sanitizer", None) is san
        pool.load(0)
        assert any(e.op == "load" for e in san.events)
    finally:
        disable()
        if was_on:                               # restore the env switch
            enable(strict=True)
    assert (enabled() is not None) == was_on
