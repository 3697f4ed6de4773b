"""The request tier of the port (serving/traffic.py + serving/frontend.py)
on the CPU, and its parity with the JAX package.

Ports of ``tests/test_traffic.py``: the seeded open-loop generator, the
``--traffic`` spec grammar, virtual-clock accounting, SLO-driven batch
formation / forced dispatch / shedding against the naive control, the
frontend -> prefetcher rate feed, and frontend-served results equal to
direct engine submission (embedding and LM).  The port's engine runs on
its host simulator (``backend="numpy"``) and on its device path in the
``torch`` kernel mode; the embedding test also runs over 2 shards
(``ShardedWeightServer``) in the ``torch`` and ``host`` kernel modes.

Parity with the reference, on the same inputs:

  * the generators give the same Request streams under one seed;
  * ``benchmarks/bench_traffic.py``'s smoke scenario (4 models, vocab 512,
    d 32, 32x32 blocks, 4 a page, half the pages as capacity, 150
    requests, max_batch 8, Zipf 1.1, seed 11, loads 0.5 / 0.9 / 2.0 of
    the naive capacity, both policies) gives exactly the reference's
    numbers: every quantity lives on the virtual clock;
  * embedding logits within 1e-5 of the reference frontend's, out of one
    SQLite store the reference wrote;
  * the reduced deepseek-7b store the reference wrote, served through
    both frontends: equal tokens and an equal dispatch sequence.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ModelStore as JModelStore
from repro.data.pipeline import SyntheticTextTask as JTask
from repro.db import DedupDB as JDB
from repro.launch.serve import build_store as jbuild_store
from repro.serving import BatchComputeModel as JComputeModel
from repro.serving import EmbeddingServingEngine as JEngine
from repro.serving import OpenLoopTraffic as JTraffic
from repro.serving import ServingFrontend as JFrontend
from repro.serving import StorageModel as JStorage
from repro.serving import WeightServer as JServer
from repro_torch import convert
from repro_torch.core import (DedupConfig, LSHConfig, ModelStore,
                              StoreConfig)
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.db import DedupDB
from repro_torch.launch.serve import build_store
from repro_torch.serving import (BatchComputeModel, EmbeddingServingEngine,
                                 LMServingEngine, OpenLoopTraffic, Prefetcher,
                                 Request, ServeStats, ServingFrontend,
                                 ShardedWeightServer, StorageModel,
                                 TrafficSpec, VirtualClock,
                                 WeightServer, zipf_weights, zoo_popularity)

torch.set_num_threads(2)

#: the port's engine paths on the CPU: its host simulator and its device
#: path with the kernels' plain versions
BACKENDS = [("numpy", "auto"), ("device", "torch")]


def _scenario(vocab=512, d=32, num_models=3, block=(32, 32), l=4, seed=0):
    task = SyntheticTextTask(vocab=vocab, d=d, seed=seed)
    store, heads = build_store(task, num_models=num_models,
                               block_shape=block, blocks_per_page=l,
                               index_mode="host")
    return task, store, heads


def _doc_payload(task, docs_per_req=3, seed_base=700):
    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(docs_per_req, variant=v,
                              seed=seed_base + rid)
        return docs
    return payload


def _requests(model, payloads, arrivals, slo):
    return [Request(rid=i, model=model, payload=p, arrival_t=t,
                    deadline=t + slo)
            for i, (p, t) in enumerate(zip(payloads, arrivals))]


def _server(store, cap, storage="dram", backend=("numpy", "auto")):
    return WeightServer(store, cap, storage=StorageModel(storage),
                        backend=backend[0], kernel_mode=backend[1])


# -------------------------------------------------------------- generator --
def test_generator_deterministic_under_seed():
    models = ["m0", "m1", "m2"]
    a = OpenLoopTraffic(models, rate=100.0, seed=4).generate(50)
    b = OpenLoopTraffic(models, rate=100.0, seed=4).generate(50)
    assert [(r.rid, r.model, r.arrival_t, r.deadline) for r in a] \
        == [(r.rid, r.model, r.arrival_t, r.deadline) for r in b]
    c = OpenLoopTraffic(models, rate=100.0, seed=5).generate(50)
    assert [r.arrival_t for r in a] != [r.arrival_t for r in c]


def test_generator_stream_continues_across_calls():
    models = ["m0", "m1"]
    gen = OpenLoopTraffic(models, rate=50.0, seed=2)
    split = gen.generate(10) + gen.generate(10)
    whole = OpenLoopTraffic(models, rate=50.0, seed=2).generate(20)
    assert [(r.rid, r.model, r.arrival_t) for r in split] \
        == [(r.rid, r.model, r.arrival_t) for r in whole]
    ts = [r.arrival_t for r in split]
    assert all(t1 > t0 for t0, t1 in zip(ts, ts[1:]))


def test_poisson_mean_interarrival_tracks_rate():
    gen = OpenLoopTraffic(["m"], rate=200.0, seed=0)
    reqs = gen.generate(4000)
    gaps = np.diff([0.0] + [r.arrival_t for r in reqs])
    assert np.mean(gaps) == pytest.approx(1.0 / 200.0, rel=0.1)


def test_zipf_popularity_skews_to_head_rank():
    models = [f"m{i}" for i in range(5)]
    reqs = OpenLoopTraffic(models, rate=100.0, zipf_alpha=1.5,
                           seed=1).generate(3000)
    counts = {m: 0 for m in models}
    for r in reqs:
        counts[r.model] += 1
    assert counts["m0"] == max(counts.values())
    assert counts["m0"] > 3 * counts["m4"]


def test_zipf_weights_shape_and_degenerate_alpha():
    w = zipf_weights(4, 1.0)
    assert w.sum() == pytest.approx(1.0)
    assert all(a > b for a, b in zip(w, w[1:]))
    np.testing.assert_allclose(zipf_weights(4, 0.0), np.full(4, 0.25))
    with pytest.raises(ValueError):
        zipf_weights(0, 1.0)


def test_zoo_popularity_covers_registry_in_rank_order():
    pop = zoo_popularity(alpha=1.2)
    from repro_torch.configs import list_archs
    assert list(pop) == list(list_archs())
    assert sum(pop.values()) == pytest.approx(1.0)
    vals = list(pop.values())
    assert all(a > b for a, b in zip(vals, vals[1:]))


def test_generator_rejects_nonpositive_rate():
    with pytest.raises(ValueError):
        OpenLoopTraffic(["m"], rate=0.0)


@pytest.mark.parametrize("models,kw,n", [
    (["m0", "m1", "m2"], dict(rate=100.0, seed=4), 50),
    ([f"w{i}" for i in range(4)], dict(rate=400.0, zipf_alpha=1.1,
                                       slo_s=0.5, seed=5), 40),
    (["a", "b"], dict(rate=30.0, zipf_alpha=2.0, slo_s=0.05, seed=11), 60),
])
def test_generator_matches_the_reference(models, kw, n):
    """One seed, one stream: rid, model, arrival and deadline exactly,
    payloads equal (drawn from the generator's own rng)."""
    def payload(model, rid, rng):
        return rng.integers(0, 512, size=(2, 5)).astype(np.int32)

    got = OpenLoopTraffic(models, payload_fn=payload, **kw).generate(n)
    want = JTraffic(models, payload_fn=payload, **kw).generate(n)
    assert [(r.rid, r.model, r.arrival_t, r.deadline) for r in got] \
        == [(r.rid, r.model, r.arrival_t, r.deadline) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.payload, b.payload)


# ------------------------------------------------------------ spec grammar --
def test_traffic_spec_parse_roundtrip_and_defaults():
    spec = TrafficSpec.parse("rate=500,zipf=1.3,slo_ms=25,seed=7")
    assert (spec.rate, spec.zipf, spec.slo_ms, spec.seed) \
        == (500.0, 1.3, 25.0, 7)
    assert spec.requests == 200 and spec.max_batch == 8
    assert TrafficSpec.parse(str(spec)) == spec
    assert TrafficSpec.parse("") == TrafficSpec()
    assert TrafficSpec.parse(None) == TrafficSpec()
    assert str(TrafficSpec()) == "default"
    assert "requests" not in str(spec)
    assert TrafficSpec.parse(spec) is spec


@pytest.mark.parametrize("bad", ["rate", "volume=3", "rate=0",
                                 "slo_ms=-1", "rate=two"])
def test_traffic_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        TrafficSpec.parse(bad)


# ------------------------------------------------------------------ clock --
def test_virtual_clock_channel_accounting():
    clk = VirtualClock()
    clk.advance(0.5, "storage")
    clk.advance(0.25, "compute")
    clk.tick_to(1.0)
    clk.tick_to(0.5)
    assert clk.now == pytest.approx(1.0)
    assert clk.spent("storage") == pytest.approx(0.5)
    assert clk.spent("idle") == pytest.approx(0.25)
    assert sum(clk.channels.values()) == pytest.approx(clk.now)
    with pytest.raises(ValueError):
        clk.advance(-0.1, "storage")


# -------------------------------------------------------------- formation --
def _frontend(store, heads, *, policy="slo", max_batch=4, storage="dram",
              cap=None, backend=BACKENDS[0]):
    server = _server(store, cap or store.num_pages(), storage, backend)
    engine = EmbeddingServingEngine(server, heads, scheduler="fifo")
    return ServingFrontend(engine, max_batch=max_batch, policy=policy,
                           compute_model=BatchComputeModel())


@pytest.mark.parametrize("backend", BACKENDS)
def test_formation_closes_batches_at_max_batch(backend):
    task, store, heads = _scenario()
    fe = _frontend(store, heads, max_batch=4, backend=backend)
    docs = [task.sample(2, variant=0, seed=s)[0] for s in range(8)]
    st = fe.run(_requests("word2vec-v0", docs, [0.0] * 8, slo=10.0))
    assert st.batches == 2
    assert [len(b) for _, b in fe.dispatched] == [4, 4]
    assert st.shed_requests == 0 and len(st.request_latencies) == 8
    assert st.goodput == 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_forced_dispatch_merges_then_beats_deadline(backend):
    """A sub-max_batch queue is held open to merge a later arrival, and
    the slack rule forces dispatch before the oldest deadline dies."""
    task, store, heads = _scenario()
    fe = _frontend(store, heads, max_batch=4, backend=backend)
    docs = [task.sample(2, variant=0, seed=s)[0] for s in range(2)]
    server = fe.engine.server
    rows = np.unique(np.concatenate([d.reshape(-1) for d in docs]))
    for p in server.embedding_rows_pages("word2vec-v0", "embedding", rows):
        server.pool.access("word2vec-v0", p)
    st = fe.run(_requests("word2vec-v0", docs, [0.0, 0.004], slo=0.05))
    assert st.batches == 1
    assert len(fe.dispatched[0][1]) == 2
    assert st.slo_misses == 0
    assert st.queue_latencies[0] > 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_shedding_drops_dead_on_arrival_requests(backend):
    task, store, heads = _scenario()
    fe = _frontend(store, heads, storage="hdd",
                   cap=max(2, store.num_pages() // 2), backend=backend)
    docs, _ = task.sample(2, variant=0, seed=0)
    st = fe.run(_requests("word2vec-v0", [docs], [0.0], slo=1e-6))
    assert st.shed_requests == 1
    assert st.request_latencies == [] and st.batches == 0
    assert st.offered_requests == 1 and st.goodput == 0.0


def test_naive_policy_dispatches_per_arrival():
    task, store, heads = _scenario()
    fe = _frontend(store, heads, policy="naive", max_batch=4)
    docs = [task.sample(2, variant=0, seed=s)[0] for s in range(6)]
    st = fe.run(_requests("word2vec-v0", docs, [0.0] * 6, slo=10.0))
    assert st.batches == 6
    assert all(len(b) == 1 for _, b in fe.dispatched)
    assert st.shed_requests == 0


def test_frontend_rejects_bad_policy_and_batch():
    _, store, heads = _scenario()
    engine = EmbeddingServingEngine(_server(store, store.num_pages()), heads)
    with pytest.raises(ValueError):
        ServingFrontend(engine, policy="greedy")
    with pytest.raises(ValueError):
        ServingFrontend(engine, max_batch=0)


# ------------------------------------------------------------ stats guard --
def test_percentiles_raise_on_empty_latency_lists():
    st = ServeStats()
    with pytest.raises(ValueError, match="empty latency list"):
        st.percentile(50)
    with pytest.raises(ValueError, match="empty request-latency list"):
        st.request_percentile(99)
    assert st.goodput == 0.0


# ----------------------------------------------------------------- λ feed --
def test_prefetcher_plan_tracks_attached_rates():
    _, store, _ = _scenario()
    server = _server(store, store.num_pages())
    pf = Prefetcher(server, hot_models=1, max_pages_per_step=4,
                    lookahead=0)
    rates = {"word2vec-v2": 5.0, "word2vec-v0": 1.0}
    pf.attach_rates(lambda: dict(rates))
    plan = pf.plan()
    assert plan and all(m == "word2vec-v2" for m, _ in plan)
    rates = {"word2vec-v2": 1.0, "word2vec-v0": 5.0}
    plan = pf.plan()
    assert plan and all(m == "word2vec-v0" for m, _ in plan)
    rates = {}
    server.pool.access("word2vec-v1", store.model_pages("word2vec-v1")[0])
    assert pf.plan()


@pytest.mark.parametrize("backend", BACKENDS)
def test_frontend_feeds_observed_rates_to_prefetcher(backend):
    task, store, heads = _scenario()
    server = _server(store, max(2, store.num_pages() // 2), backend=backend)
    pf = Prefetcher(server, hot_models=1, lookahead=0)
    engine = EmbeddingServingEngine(server, heads, scheduler="fifo",
                                    prefetcher=pf, overlap=True)
    fe = ServingFrontend(engine, max_batch=4,
                         compute_model=BatchComputeModel())
    assert pf._rate_fn is not None
    models = [f"word2vec-v{v}" for v in range(3)]
    payload = _doc_payload(task)
    fe.run(OpenLoopTraffic(models, rate=300.0, zipf_alpha=3.0, slo_s=1.0,
                           seed=3, payload_fn=payload).generate(80))
    r1 = fe.arrival_rates()
    assert max(r1, key=r1.get) == "word2vec-v0"
    gen2 = OpenLoopTraffic(list(reversed(models)), rate=300.0,
                           zipf_alpha=3.0, slo_s=1.0, seed=4,
                           payload_fn=payload)
    t0 = fe.clock.now + 1e-3
    fe.run([dataclasses.replace(r, arrival_t=r.arrival_t + t0,
                                deadline=r.deadline + t0)
            for r in gen2.generate(80)])
    r2 = fe.arrival_rates()
    assert max(r2, key=r2.get) == "word2vec-v2"
    assert r2["word2vec-v2"] > r1.get("word2vec-v2", 0.0)


# ------------------------------------------------- acceptance bit-equality --
@pytest.mark.parametrize("backend,shards", [
    pytest.param(BACKENDS[0], 1, id="backend0"),
    pytest.param(BACKENDS[1], 1, id="backend1"),
    pytest.param(("device", "torch"), 2, id="shards2-torch"),
    pytest.param(("device", "host"), 2, id="shards2-host")])
def test_frontend_logits_match_direct_submission_embedding(backend, shards):
    """Frontend-served logits are bit-identical to replaying the same
    batches through direct engine submission (1 and 2 shards)."""
    task, store, heads = _scenario(vocab=512, num_models=4)
    cap = max(4, store.num_pages() - 2)

    def make():
        if shards == 1:
            server = _server(store, cap, backend=backend)
        else:
            server = ShardedWeightServer(store, cap,
                                         storage=StorageModel("dram"),
                                         shards=shards, placement="sharers",
                                         kernel_mode=backend[1])
        return EmbeddingServingEngine(server, heads, scheduler="fifo")

    models = [f"word2vec-v{v}" for v in range(4)]
    gen = OpenLoopTraffic(models, rate=400.0, zipf_alpha=1.1, slo_s=0.5,
                          seed=5, payload_fn=_doc_payload(task))
    fe = ServingFrontend(make(), max_batch=4,
                         compute_model=BatchComputeModel())
    st = fe.run(gen.generate(40))
    assert st.shed_requests == 0 and len(fe.results) == 40

    engine2 = make()
    for model, kept in fe.dispatched:
        engine2.submit(model, np.concatenate(
            [np.asarray(r.payload) for r in kept], axis=0))
        engine2.run(max_batches=1)
        out = np.asarray(engine2.last_logits)
        row = 0
        for r in kept:
            n = np.asarray(r.payload).shape[0]
            np.testing.assert_array_equal(fe.results[r.rid],
                                          out[row: row + n])
            row += n


class _TinyLMAPI:
    """Minimal prefill/decode API over {embed, head} params: deterministic,
    model-switch faults real (the port's engine reads the device of
    ``params["embed"]``)."""

    def prefill(self, params, batch, max_len):
        x = params["embed"][batch["tokens"].long()].mean(dim=1)
        return (x @ params["head"])[:, None, :], {"x": x}

    def decode(self, params, cache, tokens):
        x = cache["x"] * 0.5 + params["embed"][tokens[:, 0].long()]
        return (x @ params["head"])[:, None, :], {"x": x}


def _rebuild(tensors, device=None):
    return {k: torch.as_tensor(v).to(device) for k, v in tensors.items()}


def _lm_setup(seed=0):
    rng = np.random.default_rng(seed)
    vocab, d = 96, 32
    emb = (rng.standard_normal((vocab, d)) * 0.1).astype(np.float32)
    head = (rng.standard_normal((d, vocab)) * 0.1).astype(np.float32)
    store = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(16, 16),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2,
                                        r=8.0, collision_threshold=6),
                          validate=False),
        blocks_per_page=4))
    names = []
    for v in range(3):
        name = f"lm-v{v}"
        names.append(name)
        emb_v = emb.copy()
        lo = v * vocab // 3
        emb_v[lo:lo + vocab // 3] += (
            rng.standard_normal((vocab // 3, d)) * 0.3).astype(np.float32)
        store.register(name, {"embed": emb_v, "head": head})
    api = _TinyLMAPI()
    return store, names, {n: api for n in names}, \
        {n: {"rebuild": _rebuild} for n in names}


@pytest.mark.parametrize("backend", BACKENDS)
def test_frontend_tokens_match_direct_submission_lm(backend):
    store, names, apis, templates = _lm_setup()
    cap = max(2, store.num_pages() // 2)

    def make():
        return LMServingEngine(_server(store, cap, backend=backend), apis,
                               templates, scheduler="fifo", overlap=True)

    def payload(model, rid, rng):
        return rng.integers(1, 96, size=(1, 5)).astype(np.int32), 3

    gen = OpenLoopTraffic(names, rate=300.0, zipf_alpha=1.1, slo_s=1.0,
                          seed=9, payload_fn=payload)
    fe = ServingFrontend(make(), max_batch=3,
                         compute_model=BatchComputeModel())
    st = fe.run(gen.generate(18))
    assert st.shed_requests == 0 and len(fe.results) == 18

    engine2 = make()
    for model, kept in fe.dispatched:
        engine2.submit(model, np.concatenate(
            [np.asarray(r.payload[0]) for r in kept], axis=0), steps=3)
        engine2.run(max_batches=1)
        out = np.asarray(engine2.last_tokens)
        row = 0
        for r in kept:
            n = np.asarray(r.payload[0]).shape[0]
            np.testing.assert_array_equal(fe.results[r.rid],
                                          out[row: row + n])
            row += n


def test_lm_merge_rejects_mixed_decode_steps():
    store, names, apis, templates = _lm_setup()
    engine = LMServingEngine(_server(store, store.num_pages(),
                                     backend=BACKENDS[1]),
                             apis, templates, scheduler="fifo")
    fe = ServingFrontend(engine, max_batch=4)
    prompts = np.ones((1, 4), np.int32)
    reqs = [Request(0, names[0], (prompts, 3), 0.0, 1.0),
            Request(1, names[0], (prompts, 4), 0.0, 1.0)]
    with pytest.raises(ValueError, match="mixed decode steps"):
        fe._merge(reqs)


# ------------------------------------------- bench_traffic's smoke scenario --
#: benchmarks/bench_traffic.py's constants and smoke configuration
BENCH_SEED, BENCH_ZIPF, BENCH_LOADS = 11, 1.1, (0.5, 0.9, 2.0)
BENCH_REQUESTS, BENCH_MAX_BATCH, BENCH_DOCS = 150, 8, 2


@pytest.fixture(scope="module")
def bench():
    """The smoke scenario's store in both packages: the reference's built
    as ``benchmarks.common.word2vec_scenario`` builds it, the port's from
    the same arrays and config (byte-identical pages)."""
    from benchmarks.common import word2vec_scenario
    task, jstore, heads, arrays = word2vec_scenario(
        num_models=4, vocab=512, d=32, block_shape=(32, 32),
        blocks_per_page=4)
    cfg = convert.store_config_from_dict(dataclasses.asdict(jstore.cfg))
    store = convert.store_from_arrays(
        cfg, {m: {"embedding": a} for m, a in arrays.items()})
    np.testing.assert_array_equal(store.page_pool(), jstore.page_pool())
    return task, jstore, store, heads


def _bench_pass(pkg, store, heads, task, rate, slo_s, policy, backend):
    """One policy pass of bench_traffic's ``_serve`` through ``pkg``
    ("jax" or "torch"): a fresh memory-pressured server and the seeded
    stream; returns the benchmark's metrics dict."""
    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(BENCH_DOCS, variant=v, seed=40_000 + rid)
        return docs

    models = sorted(heads)
    cap = max(2, store.num_pages() // 2)
    if pkg == "jax":
        gen = JTraffic(models, rate=rate, zipf_alpha=BENCH_ZIPF, slo_s=slo_s,
                       seed=BENCH_SEED, payload_fn=payload)
        server = JServer(store, cap, "optimized_mru", JStorage("ssd"))
        engine = JEngine(server, heads, scheduler="fifo", overlap=True)
        fe = JFrontend(engine, max_batch=BENCH_MAX_BATCH, policy=policy,
                       compute_model=JComputeModel(4e-4, 4e-5),
                       capture=False)
    else:
        gen = OpenLoopTraffic(models, rate=rate, zipf_alpha=BENCH_ZIPF,
                              slo_s=slo_s, seed=BENCH_SEED,
                              payload_fn=payload)
        server = WeightServer(store, cap, "optimized_mru",
                              StorageModel("ssd"), backend=backend[0],
                              kernel_mode=backend[1])
        engine = EmbeddingServingEngine(server, heads, scheduler="fifo",
                                        overlap=True)
        fe = ServingFrontend(engine, max_batch=BENCH_MAX_BATCH,
                             policy=policy,
                             compute_model=BatchComputeModel(4e-4, 4e-5),
                             capture=False)
    st = fe.run(gen.generate(BENCH_REQUESTS))
    lat = np.asarray(st.request_latencies, dtype=np.float64)
    served = len(lat)
    return {
        "offered": st.offered_requests, "served": served,
        "shed": st.shed_requests, "slo_misses": st.slo_misses,
        "goodput": st.goodput, "batches": st.batches,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3 if served else None,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3 if served else None,
        "queue_p50_ms": float(np.percentile(
            np.asarray(st.queue_latencies), 50)) * 1e3 if served else None,
        "hit_ratio": engine.server.pool.hit_ratio,
        "clock_ms": fe.clock.now * 1e3,
    }


@pytest.mark.parametrize("backend", BACKENDS)
def test_bench_traffic_smoke_matches_the_reference_exactly(bench, backend):
    """Every load rung and both policies: the port's numbers equal the
    reference's exactly (the virtual clock is deterministic)."""
    task, jstore, store, heads = bench

    def run(pkg, st_, rate, slo_s, policy):
        return _bench_pass(pkg, st_, heads, task, rate, slo_s, policy,
                           backend)

    # the naive capacity probe, as the benchmark measures it
    probe = {pkg: run(pkg, st_, 1.0, 10.0, "naive")
             for pkg, st_ in (("jax", jstore), ("torch", store))}
    assert probe["torch"] == probe["jax"]
    mean_service_s = probe["jax"]["p50_ms"] * 1e-3
    mu, slo_s = 1.0 / mean_service_s, max(0.005, 12.0 * mean_service_s)
    shed = 0
    for frac in BENCH_LOADS:
        for policy in ("slo", "naive"):
            want = run("jax", jstore, frac * mu, slo_s, policy)
            got = run("torch", store, frac * mu, slo_s, policy)
            assert got == want, (frac, policy)
            shed += got["shed"]
    assert shed > 0                    # the peak rung sheds


# ------------------------------------------------ the reference's SQLite --
@pytest.fixture(scope="module")
def reference_db(tmp_path_factory):
    """The reference's word2vec store (4 variants) saved to SQLite."""
    task = JTask(vocab=512, d=32, seed=0)
    store, heads = jbuild_store(task, 4, block_shape=(32, 32),
                                blocks_per_page=4)
    url = f"sqlite:///{tmp_path_factory.mktemp('db') / 'models.db'}"
    store.save(url)
    return task, store, heads, url


@pytest.mark.parametrize("kernel_mode", ["torch", "host"])
def test_frontend_logits_match_the_reference_frontend(reference_db,
                                                      kernel_mode):
    """One stream, one SQLite store, both frontends: the same dispatch
    sequence and per-request logits within 1e-5."""
    task, store, heads, url = reference_db
    cap = max(4, store.num_pages() - 2)
    models = sorted(heads)

    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(3, variant=v, seed=700 + rid)
        return docs

    kw = dict(rate=400.0, zipf_alpha=1.1, slo_s=0.05, seed=5,
              payload_fn=payload)
    jdb = JDB.open(url)
    jeng = jdb.serve_embedding(heads, capacity_pages=cap,
                               storage=JStorage("dram"),
                               compute_backend="device", kernel_mode="host",
                               scheduler="fifo")
    jfe = JFrontend(jeng, max_batch=4, compute_model=JComputeModel())
    jst = jfe.run(JTraffic(models, **kw).generate(60))
    db = DedupDB.open(url)
    eng = db.serve_embedding(heads, capacity_pages=cap,
                             storage=StorageModel("dram"),
                             kernel_mode=kernel_mode, scheduler="fifo")
    fe = ServingFrontend(eng, max_batch=4, compute_model=BatchComputeModel())
    st = fe.run(OpenLoopTraffic(models, **kw).generate(60))
    jdb.close()
    db.close()
    assert [(m, [r.rid for r in b]) for m, b in fe.dispatched] \
        == [(m, [r.rid for r in b]) for m, b in jfe.dispatched]
    assert (st.offered_requests, st.shed_requests, st.slo_misses) \
        == (jst.offered_requests, jst.shed_requests, jst.slo_misses)
    assert st.request_latencies == jst.request_latencies
    assert fe.results.keys() == jfe.results.keys()
    assert eng.stats.dense_fallbacks == 0
    for rid, want in jfe.results.items():
        np.testing.assert_allclose(fe.results[rid], want, atol=1e-5)


@pytest.fixture(scope="module")
def reference_lm(tmp_path_factory):
    """The reference's reduced deepseek-7b, two variants, in SQLite."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.core import DedupConfig as JDedup
    from repro.core import LSHConfig as JLSH
    from repro.core import StoreConfig as JStoreCfg
    from repro.models import build as jbuild
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build
    cfg = jreduced(jget_config("deepseek-7b"))
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

    store = JModelStore(JStoreCfg(
        dedup=JDedup(block_shape=(32, 32),
                     lsh=JLSH(num_bands=8, rows_per_band=2, r=4.0,
                              collision_threshold=6),
                     validate=False),
        blocks_per_page=8))
    store.register("lm-v0", tensors)
    store.register("lm-v1", {k: v + 1e-5 for k, v in tensors.items()})
    url = f"sqlite:///{tmp_path_factory.mktemp('lm') / 'lm.db'}"
    store.save(url)
    lm = convert.lm_tensors(jax.tree_util.tree_map(np.asarray, params))
    return dict(url=url, japi=japi, jrebuild=jrebuild, lm=lm,
                tapi=build(reduced(get_config("deepseek-7b"))),
                cap=max(len(store.model_pages(m))
                        for m in ("lm-v0", "lm-v1")))


def test_lm_frontend_matches_the_reference_frontend(reference_lm):
    """The reference's LM store through both frontends (the port in torch
    mode): equal dispatch sequences and equal tokens per request."""
    r = reference_lm
    names = ["lm-v0", "lm-v1"]

    def payload(model, rid, rng):
        return rng.integers(1, 256, size=(1, 8)).astype(np.int32), 3

    kw = dict(rate=200.0, zipf_alpha=1.1, slo_s=1.0, seed=3,
              payload_fn=payload)
    jdb = JDB.open(r["url"])
    jeng = jdb.serve_lm({m: r["japi"] for m in names},
                        {m: {"rebuild": r["jrebuild"]} for m in names},
                        capacity_pages=r["cap"], storage=JStorage("dram"),
                        compute_backend="device", kernel_mode="host")
    jfe = JFrontend(jeng, max_batch=3, compute_model=JComputeModel())
    jfe.run(JTraffic(names, **kw).generate(9))
    db = DedupDB.open(r["url"])
    eng = db.serve_lm({m: r["tapi"] for m in names},
                      {m: {"rebuild": r["lm"].rebuild} for m in names},
                      capacity_pages=r["cap"], storage=StorageModel("dram"),
                      kernel_mode="torch")
    fe = ServingFrontend(eng, max_batch=3, compute_model=BatchComputeModel())
    fe.run(OpenLoopTraffic(names, **kw).generate(9))
    jdb.close()
    db.close()
    assert [(m, [q.rid for q in b]) for m, b in fe.dispatched] \
        == [(m, [q.rid for q in b]) for m, b in jfe.dispatched]
    assert len(fe.dispatched) > 1
    assert fe.results.keys() == jfe.results.keys()
    for rid, want in jfe.results.items():
        np.testing.assert_array_equal(fe.results[rid], want)
