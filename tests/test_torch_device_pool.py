"""The port's device page pool and transfer engine against the JAX
package's, on the CPU.

The scenarios of ``tests/test_device_pool.py`` run in the port's
``host`` and ``torch`` kernel modes.  Each builds the same store twice
from one seed — once with the reference, once with the port (the
copies of the dedup core make them byte-identical) — serves the same
traffic through both, and holds the port against the reference
``WeightServer`` (numpy backend, and the device backend in ``host`` or
``pallas`` mode): logits within 1e-5 (DESIGN.md §3).  The transfer
engine's one-bump-per-group and exception-safety contracts, and the
refusal of ``kernel_mode="auto"`` without a card, are checked too.
"""
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticTextTask as JTask
from repro.launch.serve import build_store as jbuild_store
from repro.serving.engine import EmbeddingServingEngine as JEngine
from repro.serving.engine import StorageModel as JStorage
from repro.serving.engine import WeightServer as JServer
from repro_torch.core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import build_store
from repro_torch.serving.device_pool import DevicePagePool
from repro_torch.serving.engine import (EmbeddingServingEngine, StorageModel,
                                        WeightServer)

torch.set_num_threads(2)

MODES = ["host", "torch"]


def _scenarios(vocab=512, d=32, num_models=3, block=(32, 32), l=4, seed=0):
    """(task, port store, heads, reference store, reference heads)."""
    task = SyntheticTextTask(vocab=vocab, d=d, seed=seed)
    store, heads = build_store(task, num_models=num_models,
                               block_shape=block, blocks_per_page=l,
                               index_mode="host")
    jtask = JTask(vocab=vocab, d=d, seed=seed)
    jstore, jheads = jbuild_store(jtask, num_models=num_models,
                                  block_shape=block, blocks_per_page=l)
    np.testing.assert_array_equal(store.page_pool(), jstore.page_pool())
    for m in heads:
        np.testing.assert_array_equal(heads[m], jheads[m])
    return task, store, heads, jstore, jheads


def _run_batches(engine, task, num_models, batches=6, batch=16, seed=0):
    """Drive the engine one batch at a time, returning per-batch logits."""
    out = []
    for b in range(batches):
        v = b % num_models
        docs, _ = task.sample(batch, variant=v, seed=seed + 100 + b)
        engine.submit(f"word2vec-v{v}", docs)
        engine.run(max_batches=1)
        out.append(engine.last_logits.copy())
    return out


def _ref_logits(jstore, jheads, task, cap, backend="numpy",
                kernel_mode="auto", **kw):
    server = JServer(jstore, cap, storage=JStorage("dram"), backend=backend,
                     kernel_mode=kernel_mode)
    engine = JEngine(server, jheads)
    return _run_batches(engine, task, **kw), server


def _port(store, cap, kernel_mode, **kw):
    return WeightServer(store, cap, storage=StorageModel("dram"),
                        kernel_mode=kernel_mode, **kw)


def _close(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_allclose(a, b, atol=1e-5)


# ------------------------------------------------------------ equivalence --
@pytest.mark.parametrize("kernel_mode", MODES)
def test_device_logits_match_reference(kernel_mode):
    """Port device logits == reference numpy == reference device (host
    mirror and Pallas interpret) logits (atol 1e-5)."""
    task, store, heads, jstore, jheads = _scenarios(vocab=256)
    cap = store.num_pages()
    server = _port(store, cap, kernel_mode)
    engine = EmbeddingServingEngine(server, heads)
    got = _run_batches(engine, task, 3, batches=4, batch=8)
    assert engine.stats.device_batches == 4
    assert engine.stats.dense_fallbacks == 0
    for backend, km in (("numpy", "auto"), ("device", "host"),
                        ("device", "pallas")):
        want, _ = _ref_logits(jstore, jheads, task, cap, backend, km,
                              num_models=3, batches=4, batch=8)
        _close(want, got)


@pytest.mark.parametrize("kernel_mode", MODES)
def test_device_hot_path_never_materializes(monkeypatch, kernel_mode):
    """Zero calls to dedup.materialize / materialize_rows on the
    steady-state device hot path, and the reference's logits."""
    task, store, heads, jstore, jheads = _scenarios()
    server = _port(store, store.num_pages(), kernel_mode)
    engine = EmbeddingServingEngine(server, heads)
    _run_batches(engine, task, 3, batches=3)        # warm the slab

    def bump(*a, **k):
        raise AssertionError("host materialization on device hot path")

    monkeypatch.setattr(store.dedup, "materialize", bump)
    monkeypatch.setattr(store, "materialize_rows", bump)
    got = _run_batches(engine, task, 3, batches=6, seed=50)
    assert engine.stats.dense_fallbacks == 0
    want, _ = _ref_logits(jstore, jheads, task, jstore.num_pages(),
                          num_models=3, batches=6, seed=50)
    _close(want, got)


@pytest.mark.parametrize("kernel_mode", MODES)
def test_partial_residency_still_serves_from_device(kernel_mode):
    """The slab only needs the *batch's* pages: with capacity below the
    working set every batch still computes off the slab, and the pool
    makes the reference pool's hit/miss decisions."""
    task, store, heads, jstore, jheads = _scenarios(vocab=1024,
                                                    num_models=4)
    docs, _ = task.sample(16, variant=0, seed=7)
    probe = _port(store, 2, kernel_mode)
    batch_pages = len(probe.embedding_rows_pages(
        "word2vec-v0", "embedding", np.unique(docs)))
    cap = min(store.num_pages() - 1, batch_pages + 2)
    server = _port(store, cap, kernel_mode)
    engine = EmbeddingServingEngine(server, heads)
    got = _run_batches(engine, task, 4, batches=8)
    assert engine.stats.device_batches > 0
    assert server.pool.misses > 0                # pages churned
    want, jserver = _ref_logits(jstore, jheads, task, cap, "device", "host",
                                num_models=4, batches=8)
    _close(want, got)
    assert server.pool.hit_ratio == jserver.pool.hit_ratio
    assert engine.stats.device_batches == sum(1 for _ in got)


# ------------------------------------------------------- slab invariants --
@pytest.mark.parametrize("kernel_mode", MODES)
def test_slab_residency_matches_pool_under_churn(kernel_mode):
    """The pool's resident set == the slab's occupied slots, slot bytes
    == the physical pages, and both follow the reference device pool
    step by step under access/prefetch/evict churn."""
    _, store, _, jstore, _ = _scenarios(num_models=4)
    cap = max(2, store.num_pages() // 3)
    server = _port(store, cap, kernel_mode)
    jserver = JServer(jstore, cap, storage=JStorage("dram"),
                      backend="device", kernel_mode="host")
    pool, dev = server.pool, server.device_pool
    models = list(store.dedup.models)
    rng = np.random.default_rng(0)
    npages = store.num_pages()
    for _ in range(300):
        m = models[int(rng.integers(len(models)))]
        p = int(rng.integers(npages))
        if rng.random() < 0.25:
            pool.prefetch(m, p)
            jserver.pool.prefetch(m, p)
        else:
            pool.access(m, p)
            jserver.pool.access(m, p)
        assert pool.resident_pages() == dev.resident_pages()
        assert dev.slot_of == jserver.device_pool.slot_of
        occ = dev.occupied_slots()
        assert len(occ) == len(dev.slot_of)              # slots unique
        assert len(occ) + len(dev._free) == dev.capacity
        assert len(pool.resident) <= cap
    for pid, slot in dev.slot_of.items():
        np.testing.assert_array_equal(dev.slot_page(slot),
                                      store.page_array(pid))


# ------------------------------------------------- staleness / invalidation --
@pytest.mark.parametrize("kernel_mode", MODES)
def test_model_update_invalidates_pool_and_slab(kernel_mode):
    """A model update repacks and flushes every consumer, so the port
    serves the *new* weights — the reference's post-update logits."""
    task, store, heads, jstore, jheads = _scenarios()
    server = _port(store, store.num_pages(), kernel_mode)
    engine = EmbeddingServingEngine(server, heads)
    jserver = JServer(jstore, jstore.num_pages(), storage=JStorage("dram"),
                      backend="numpy")
    jengine = JEngine(jserver, jheads)
    _run_batches(engine, task, 3, batches=3)
    _run_batches(jengine, task, 3, batches=3)
    gen0 = store.pack_generation

    new_emb = task.variant_embedding(0) + 0.25
    store.update("word2vec-v0", {"embedding": new_emb})
    jstore.update("word2vec-v0", {"embedding": new_emb})
    docs, _ = task.sample(16, variant=0, seed=999)
    for e in (engine, jengine):
        e.submit("word2vec-v0", docs)
        e.run(max_batches=1)
    assert store.pack_generation > gen0
    np.testing.assert_allclose(engine.last_logits, jengine.last_logits,
                               atol=1e-5)
    dev = server.device_pool
    for pid, slot in dev.slot_of.items():
        np.testing.assert_array_equal(dev.slot_page(slot),
                                      store.page_array(pid))


# ------------------------------------------------------- FFNN (Sec. 7.1.3) --
def _matmul_stores():
    cfg = dict(block_shape=(16, 16),
               lsh=dict(num_bands=8, rows_per_band=2, r=8.0,
                        collision_threshold=6),
               validate=False)
    from repro.core import DedupConfig as JD
    from repro.core import LSHConfig as JL
    from repro.core import ModelStore as JStore
    from repro.core import StoreConfig as JC
    rng = np.random.default_rng(0)
    base = rng.standard_normal((64, 40)).astype(np.float32)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    stores = []
    for D, L, S, C in ((DedupConfig, LSHConfig, ModelStore, StoreConfig),
                       (JD, JL, JStore, JC)):
        s = S(C(dedup=D(block_shape=cfg["block_shape"], lsh=L(**cfg["lsh"]),
                        validate=False), blocks_per_page=4))
        s.register("m0", {"w": base})
        s.register("m1", {"w": base + 1e-5})
        stores.append(s)
    return stores[0], stores[1], x


@pytest.mark.parametrize("kernel_mode", MODES)
def test_device_matmul_and_tensor_match_reference(kernel_mode):
    """dedup_matmul / unblock against the slab == dense math == the
    reference's device_matmul / device_tensor (host and Pallas modes)."""
    store, jstore, x = _matmul_stores()
    server = _port(store, store.num_pages(), kernel_mode)
    server.access_pages("m1", store.model_pages("m1"))
    dense = store.materialize("m1", "w")
    y = np.asarray(server.device_matmul("m1", "w", x))
    np.testing.assert_allclose(y, x @ dense, rtol=1e-4, atol=1e-4)
    t = np.asarray(server.device_tensor("m1", "w"))
    np.testing.assert_allclose(t, dense, atol=1e-6)
    for km in ("host", "pallas"):
        js = JServer(jstore, jstore.num_pages(), storage=JStorage("dram"),
                     backend="device", kernel_mode=km)
        js.access_pages("m1", jstore.model_pages("m1"))
        np.testing.assert_allclose(
            y, np.asarray(js.device_matmul("m1", "w", x)), rtol=1e-4,
            atol=1e-4)
        np.testing.assert_allclose(
            t, np.asarray(js.device_tensor("m1", "w")), atol=1e-6)


# --------------------------------------------------------- transfer engine --
@pytest.mark.parametrize("kernel_mode", MODES)
def test_group_load_bumps_generation_once(kernel_mode):
    """The remap-cache generation bumps ONCE per committed group, not
    once per page (the per_page path keeps its bump-per-page), and the
    slab holds the store's pages either way."""
    _, store, _, _, _ = _scenarios()
    pages = list(range(store.num_pages()))
    for transfer, expected in (("grouped", 1), ("per_page", len(pages))):
        server = _port(store, store.num_pages(), kernel_mode,
                       transfer=transfer)
        gen0 = server.device_pool.generation
        server.access_pages_grouped("word2vec-v0", pages)
        assert server.device_pool.generation - gen0 == expected, transfer
        assert server.device_pool.loads == len(pages)
        assert set(server.device_pool.slot_of) == set(pages)
        for pid in pages:
            np.testing.assert_array_equal(
                server.device_pool.slot_page(server.device_pool.slot_of[pid]),
                store.page_array(pid))


@pytest.mark.parametrize("kernel_mode", MODES)
def test_failed_group_commit_leaves_pool_untouched(monkeypatch, kernel_mode):
    """Exception safety: a device leg that fails returns every popped
    slot to the free list and bumps no generation."""
    _, store, _, _, _ = _scenarios()
    server = _port(store, store.num_pages(), kernel_mode)
    dev = server.device_pool
    free0, gen0 = list(dev._free), dev.generation

    def boom(*a, **k):
        raise RuntimeError("injected device-leg failure")

    if kernel_mode == "host":
        mirror = dev.host_slab.copy()
        mirror.setflags(write=False)              # the mirror write fails
        monkeypatch.setattr(dev, "host_slab", mirror)
    else:
        monkeypatch.setattr(dev.transfer, "ship", boom)
    with pytest.raises((RuntimeError, ValueError)):
        dev.load_group([0, 1, 2])
    assert sorted(dev._free) == sorted(free0)
    assert dev.generation == gen0
    assert dev.slot_of == {} and (dev._page_to_slot == -1).all()
    assert dev.transfer.stats.groups == 0


@pytest.mark.parametrize("kernel_mode", MODES)
def test_overlap_prestages_next_batch(kernel_mode):
    """Double buffer: with overlap on, the next queued batch's pages are
    staged while the current batch computes, its commit consumes the
    staged bytes, and the logits stay the reference's."""
    task, store, heads, jstore, jheads = _scenarios(vocab=1024,
                                                    num_models=4)
    server = _port(store, store.num_pages(), kernel_mode)
    engine = EmbeddingServingEngine(server, heads, scheduler="fifo",
                                    overlap=True)
    jengine = JEngine(JServer(jstore, jstore.num_pages(),
                              storage=JStorage("dram"), backend="numpy"),
                      jheads, scheduler="fifo", overlap=True)
    for b in range(4):                       # queue up front: real lookahead
        docs, _ = task.sample(16, variant=b % 4, seed=900 + b)
        engine.submit(f"word2vec-v{b % 4}", docs)
        jengine.submit(f"word2vec-v{b % 4}", docs)
    got, want = [], []
    for _ in range(4):
        engine.run(max_batches=1)
        jengine.run(max_batches=1)
        got.append(engine.last_logits.copy())
        want.append(jengine.last_logits.copy())
    _close(want, got)
    stats = engine.stats
    assert stats.transfer_pages == server.device_pool.loads
    assert 0.0 < stats.overlap_fraction <= 1.0
    assert stats.mean_group_size > 1.0       # groups actually coalesced


# ------------------------------------------------------------------- modes --
@pytest.mark.parametrize("trigger", ["oversized_group", "not_resident",
                                     "storage_fault"])
def test_only_cpu_modes_fall_back_to_the_host(monkeypatch, trigger):
    """A batch the slab cannot serve goes to the host in the CPU modes
    (the reference's fallback, counted) and raises in cuda mode, where
    the slab is on the card.  ``host_fallback_allowed`` is forced false
    here to stand for cuda mode on the CPU."""
    from repro_torch.storage.faults import StorageFaultError
    task, store, heads, _, _ = _scenarios(vocab=1024)
    docs, _ = task.sample(16, variant=0, seed=7)
    model = "word2vec-v0"
    want = store.materialize(model, "embedding")[docs].mean(axis=1) \
        @ heads[model]
    for on_card in (False, True):
        probe = _port(store, 2, "torch")
        pages = len(probe.embedding_rows_pages(model, "embedding",
                                               np.unique(docs)))
        cap = pages - 1 if trigger == "oversized_group" else pages
        server = _port(store, cap, "torch")
        assert server.host_fallback_allowed()
        if trigger == "not_resident":
            monkeypatch.setattr(server, "device_gather_rows",
                                lambda *a, **k: None)
        elif trigger == "storage_fault":
            def fail(*a, **k):
                raise StorageFaultError("injected: retry budget spent")
            monkeypatch.setattr(server, "access_pages", fail)
        if on_card:
            monkeypatch.setattr(server, "host_fallback_allowed",
                                lambda: False)
        engine = EmbeddingServingEngine(server, heads)
        engine.submit(model, docs)
        if on_card:
            with pytest.raises((RuntimeError, ValueError)):
                engine.run(max_batches=1)
            assert engine.stats.batches == 0
            continue
        engine.run(max_batches=1)
        assert engine.stats.device_batches == 0
        assert engine.stats.dense_fallbacks \
            + engine.stats.degraded_batches == 1
        np.testing.assert_allclose(engine.last_logits, want, atol=1e-5)
    pool = _port(store, 2, "torch").device_pool
    monkeypatch.setattr(pool, "mode", lambda: "cuda")
    server = _port(store, 2, "torch")
    server.device_pool = pool
    assert not server.host_fallback_allowed()


def test_auto_mode_refuses_without_cuda():
    """``auto`` means the CUDA kernels: without a card it raises rather
    than falling back to the CPU, and so does the default server."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: auto resolves to cuda")
    _, store, _, _, _ = _scenarios()
    with pytest.raises(RuntimeError):
        DevicePagePool(store, 2)
    with pytest.raises(RuntimeError):
        WeightServer(store, 2)                   # backend="device", auto
    with pytest.raises(ValueError):
        DevicePagePool(store, 2, kernel_mode="pallas")
    # the host simulator is asked for by name
    assert WeightServer(store, 2, backend="numpy").device_pool is None
