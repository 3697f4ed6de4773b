"""Serving launcher: the paper's multi-model embedding scenario end to end.

Counterpart of ``repro.launch.serve`` (embedding engine).  Builds N
fine-tuned variants, registers them in the dedup ModelStore (Alg. 1 ->
two-stage packing), then serves mixed-model request traffic through the
Eq.-2 buffer pool, reporting storage reduction, cache hit ratio, and
latency — the same ``[store] [serve] [device] [transfer]`` lines as the
reference.

With ``--store-url`` the store is committed to a storage backend
(``file://`` dir, ``sqlite://`` database or ``objsim://`` simulated
object store) and served back *live* through ``repro_torch.db.DedupDB``.

``--backend device`` (the default) serves through the device page slab
with the CUDA kernels and needs an NVIDIA GPU of capability (9, 0)
(``--kernel-mode torch`` / ``host`` serve the slab with the kernels'
plain versions / numpy on the CPU); ``--backend numpy`` is the host
simulator.  ``--shards N`` partitions the slab across N per-shard slabs
(``--placement hash`` or ``sharers``; capacity is per shard) and prints
a ``[shards]`` line.

``--engine lm`` serves reduced deepseek-7b variants with prefill and
``--lm-steps`` greedy decode steps; their weights fault in through the
page pool at every model switch, and prefill attention runs the
``flash_attention`` kernel on the card.

``--traffic SPEC`` replaces the pre-built batches with an open-loop
request stream (Poisson arrivals, Zipf model popularity) served through
the ``ServingFrontend`` (SLO-driven batch formation, cost-based
admission, shedding) on a virtual clock, and prints a ``[traffic]``
line.  ``--snapshot PATH`` persists the frontend's state around every
dispatch and resumes from PATH when it exists; ``--kill-after N`` stops
after N dispatches (warm restart, DESIGN.md §11).  ``--trace`` and
``--report-json`` export the request-path trace and a metrics snapshot.

The store's Alg.-1 index build signs blocks in ``--index-mode``: by
default on the card (the ``lsh_signature`` kernel) with ``--backend
device`` and on the host (the reference's numpy routine) with
``--backend numpy``.  An ``[index]`` line reports the signature step
beside the build.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --models 6 --batches 60
  PYTHONPATH=src python -m repro_torch.launch.serve --backend numpy
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --store-url sqlite:////tmp/m.db
  PYTHONPATH=src python -m repro_torch.launch.serve --engine lm --batches 8
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 2 \
      --placement hash --models 4
  PYTHONPATH=src python -m repro_torch.launch.serve --backend numpy \
      --traffic rate=400,requests=40,slo_ms=200,max_batch=4 \
      --snapshot /tmp/fe.json --kill-after 3
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np

from ..core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from ..core.device_index import DeviceModelStore
from ..core.lsh import estimate_r
from ..data.pipeline import SyntheticTextTask
from ..serving.device_pool import KERNEL_MODES
from ..serving.engine import (EmbeddingServingEngine, LMServingEngine,
                              ServeStats, StorageModel, WeightServer)
from ..serving.frontend import ServingFrontend
from ..serving.prefetch import Prefetcher
from ..serving.scheduler import SCHEDULERS
from ..serving.traffic import OpenLoopTraffic, TrafficSpec


def build_store(task: SyntheticTextTask, num_models: int,
                block_shape=(64, 64), blocks_per_page: int = 8,
                pack_strategy: str = "two_stage", index_mode: str = "auto"):
    """The reference CLI's word2vec store, its index signed in
    ``index_mode`` (default: on the card).  Returns (store, heads)."""
    from ..core.blocks import block_tensor
    base_blocks, _ = block_tensor(task.base_embed, block_shape)
    r = estimate_r(base_blocks, quantile=0.5)
    cfg = StoreConfig(
        dedup=DedupConfig(
            block_shape=block_shape,
            lsh=LSHConfig(num_bands=16, rows_per_band=4, r=r,
                          collision_threshold=8),
            validate=False),
        blocks_per_page=blocks_per_page,
        pack_strategy=pack_strategy)
    store = DeviceModelStore(cfg, index_mode=index_mode)
    heads = {}
    for v in range(num_models):
        name = f"word2vec-v{v}"
        emb = task.variant_embedding(v)
        store.register(name, {"embedding": emb})
        heads[name] = task.train_head(emb, variant=v)
    return store, heads


def build_lm_store(cfg, num_models: int, seed: int = 0,
                   index_mode: str = "auto"):
    """``num_models`` variants of an LM: numpy weights from ``seed``
    (``models.transformer.init_params``), variant v shifted by 1e-5 * v,
    registered into a store of 32x32 blocks, 8 a page, as the reference
    CLI builds its LM store, its index signed in ``index_mode``.
    Returns (store, names, lm_tensors).  Any decoder-only family; an
    encoder-decoder config raises ``ValueError``."""
    from ..convert import lm_tensors
    from ..models.transformer import init_params
    if cfg.encdec:
        raise ValueError(f"{cfg.name}: the LM store holds decoder-only "
                         f"models; the LM engine cannot prefill an "
                         f"encoder-decoder from tokens alone")
    lm = lm_tensors(init_params(cfg, seed), dtype=cfg.dtype)
    store = DeviceModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2,
                                        r=4.0, collision_threshold=6),
                          validate=False),
        blocks_per_page=8), index_mode=index_mode)
    names = []
    for v in range(num_models):
        name = f"lm-v{v}"
        names.append(name)
        delta = 0.0 if v == 0 else 1e-5 * v
        store.register(name, {k: t + delta for k, t in lm.tensors.items()})
    return store, names, lm


# Audit map: every ServeStats field -> (report tag, key on that line).
# tests/test_torch_obs.py pins this map against dataclasses.fields
# (ServeStats), so growing a counter without deciding its report line
# fails, and no field is printed from two lines at once.
REPORT_FIELDS = {
    "requests": ("serve", "requests="),
    "batches": ("serve", "batches="),
    "fetch_seconds": ("serve", "fetch="),
    "compute_seconds": ("serve", "compute="),
    "prefetch_seconds": ("serve", "prefetch="),
    "pages_fetched": ("serve", "pages="),
    "timeline_seconds": ("serve", "makespan="),
    "overlapped": ("serve", "overlap="),
    "latencies": ("serve", "p50=/p99="),
    "fetch_latencies": ("serve", "fetch_p99="),
    "device_batches": ("device", "device_batches="),
    "dense_fallbacks": ("device", "dense_fallbacks="),
    "transfer_seconds": ("transfer", "moved="),
    "transfer_pages": ("transfer", "pages="),
    "transfer_groups": ("transfer", "ops="),
    "transfer_bytes": ("transfer", "bytes="),
    "transfer_overlapped_bytes": ("transfer", "overlap="),
    "group_sizes": ("transfer", "mean_group="),
    "prefetch_pages": ("prefetch", "pages="),
    "borrow_pages": ("shards", "borrows="),
    "borrow_seconds": ("shards", "borrow="),
    "borrow_mirror_hits": ("shards", "mirror="),
    "borrow_store_faults": ("shards", "owner_faults="),
    "borrow_coalesced": ("shards", "coalesced="),
    "shard_batches": ("shards", "batches_per_shard="),
    "retries": ("faults", "retries="),
    "corrupt_detected": ("faults", "corrupt="),
    "refetch_pages": ("faults", "refetch="),
    "failovers": ("faults", "failovers="),
    "degraded_batches": ("faults", "degraded="),
    "fault_backoff_seconds": ("faults", "backoff="),
    "offered_requests": ("traffic", "offered="),
    "shed_requests": ("traffic", "shed="),
    "slo_misses": ("traffic", "slo_miss="),
    "queue_latencies": ("traffic", "queue_p50="),
    "service_latencies": ("traffic", "service_p50="),
    "request_latencies": ("traffic", "served=/p50=/p99="),
    "readmitted_requests": ("traffic", "readmitted="),
}


def _print_index(store: DeviceModelStore) -> None:
    st = store.dedup.index_stats
    print(f"[index] mode={store.dedup.index.lsh.resolved_mode()} "
          f"blocks={st.blocks} launches={st.launches} "
          f"sign_device={st.sign_device_seconds*1e3:.2f}ms "
          f"h2d={st.h2d_seconds*1e3:.2f}ms "
          f"sign_wall={st.sign_wall_seconds:.3f}s "
          f"build={st.build_seconds:.3f}s")


def _print_stats(args, stats: ServeStats, server: WeightServer,
                 engine=None) -> None:
    if args.backend == "device":
        print(f"[device] slab={server.device_pool.capacity} pages "
              f"loads={server.device_pool.loads} "
              f"evicts={server.device_pool.evicts} "
              f"device_batches={stats.device_batches} "
              f"dense_fallbacks={stats.dense_fallbacks} "
              f"mode={server.device_pool.mode()}")
        hbm = server._hbm()
        print(f"[transfer] mode={args.transfer} "
              f"pages={stats.transfer_pages} ops={stats.transfer_groups} "
              f"mean_group={stats.mean_group_size:.1f} "
              f"bytes={stats.transfer_bytes} "
              f"moved={stats.transfer_seconds*1e3:.2f}ms "
              f"overlap={stats.overlap_fraction:.2f} "
              f"hbm_bw={hbm.bw/1e6:.0f}MB/s hbm_seek={hbm.seek*1e6:.0f}us")
    pf = getattr(engine, "prefetcher", None)
    if pf is not None:
        print(f"[prefetch] pages={stats.prefetch_pages} "
              f"time={pf.stats.seconds*1e3:.2f}ms "
              f"issued={pf.stats.issued} declined={pf.stats.declined} "
              f"lookahead_issued={pf.stats.lookahead_issued} "
              f"lookahead_hits={pf.stats.lookahead_hits}")
    if getattr(args, "shards", 1) > 1:
        s = server.stats                 # borrow/routing live on the server
        print(f"[shards] n={args.shards} placement={args.placement} "
              f"batches_per_shard={dict(sorted(s.shard_batches.items()))} "
              f"borrows={s.borrow_pages} "
              f"(mirror={s.borrow_mirror_hits} "
              f"owner_faults={s.borrow_store_faults} "
              f"coalesced={s.borrow_coalesced}) "
              f"rebalanced={server.router.rebalanced} "
              f"borrow={s.borrow_seconds*1e3:.2f}ms")
    if getattr(args, "faults", None):
        # recovery counters accumulate on the server's stats (where the
        # access-path accounting lives); degradation is an engine event
        fs = server.stats
        print(f"[faults] retries={fs.retries} "
              f"corrupt={fs.corrupt_detected} "
              f"refetch={fs.refetch_pages} "
              f"failovers={fs.failovers} "
              f"degraded={stats.degraded_batches} "
              f"backoff={fs.fault_backoff_seconds*1e3:.2f}ms")
    # percentile() raises on an empty run (a silent 0.0 would read as an
    # impossibly fast tail); an empty run prints n/a instead
    lat = (f"p50={stats.percentile(50)*1e3:.2f}ms "
           f"p99={stats.percentile(99)*1e3:.2f}ms") if stats.latencies \
        else "p50=n/a p99=n/a"
    fl = stats.fetch_latencies
    fetch_p99 = (f"fetch_p99="
                 f"{float(np.percentile(fl, 99))*1e3:.2f}ms") if fl \
        else "fetch_p99=n/a"
    # overlap= reports what the engine DID (stats.overlapped), not what
    # the CLI asked for — the two differ when a flag implies overlap
    print(f"[serve] batches={stats.batches} requests={stats.requests} "
          f"scheduler={args.scheduler} overlap={stats.overlapped} "
          f"backend={args.backend} "
          f"hit_ratio={server.pool.hit_ratio:.3f} "
          f"pages={stats.pages_fetched} "
          f"fetch={stats.fetch_seconds*1e3:.1f}ms " + fetch_p99 +
          f" prefetch={stats.prefetch_seconds*1e3:.1f}ms "
          f"compute={stats.compute_seconds*1e3:.1f}ms "
          f"makespan={stats.makespan_seconds*1e3:.1f}ms " + lat)


def _print_traffic(spec: TrafficSpec, fe: ServingFrontend,
                   stats: ServeStats) -> None:
    """The ``[traffic]`` report line: request-level latency/goodput for
    an open-loop run (virtual-clock quantities throughout)."""
    served = len(stats.request_latencies)
    lat = (f"p50={stats.request_percentile(50)*1e3:.2f}ms "
           f"p99={stats.request_percentile(99)*1e3:.2f}ms") if served \
        else "p50=n/a p99=n/a"
    if served:
        q50 = float(np.percentile(stats.queue_latencies, 50)) * 1e3
        s50 = float(np.percentile(stats.service_latencies, 50)) * 1e3
        qs = f"queue_p50={q50:.2f}ms service_p50={s50:.2f}ms "
    else:
        qs = "queue_p50=n/a service_p50=n/a "
    print(f"[traffic] policy={fe.policy} rate={spec.rate:g}/s "
          f"zipf={spec.zipf:g} slo={spec.slo_ms:g}ms seed={spec.seed} "
          f"offered={stats.offered_requests} served={served} "
          f"shed={stats.shed_requests} slo_miss={stats.slo_misses} "
          f"readmitted={stats.readmitted_requests} "
          f"goodput={stats.goodput:.3f} " + qs + lat +
          f" clock={fe.clock.now*1e3:.1f}ms "
          f"idle={fe.clock.spent('idle')*1e3:.1f}ms")


def _make_tracer(args, clock=None):
    """(tracer, activation-CM) for --trace; (None, no-op CM) otherwise.
    Binding the frontend's virtual clock lets the exporter carry the
    per-channel conservation proof in ``otherData``."""
    if not getattr(args, "trace", None):
        return None, contextlib.nullcontext()
    from ..obs import Tracer, use_tracer
    tr = Tracer(clock=clock)
    return tr, use_tracer(tr)


def _run_traffic(args, engine, gen: OpenLoopTraffic, spec: TrafficSpec):
    """One open-loop traffic run through the ServingFrontend, honouring
    the warm-restart flags (DESIGN.md §11).

    With ``--snapshot PATH`` the frontend persists its clock / ledger /
    queues around every dispatch; if PATH already exists the run RESUMES
    from it — the seeded generator reproduces the same request stream,
    the ledger keeps served ids served (at-most-once), and queued plus
    in-flight ids are re-admitted for deterministic recompute.
    ``--kill-after N`` stops after N dispatched batches so a follow-up
    invocation of the same command exercises the resume path.

    Returns ``(fe, stats, tracer, clock)``; ``clock`` is ``None`` on a
    resumed run because the restored ledger carries pre-crash channel
    time no span of this process witnessed, so the tracer's exact
    clock-conservation cross-check cannot apply.
    """
    import json
    import os
    snap_path = getattr(args, "snapshot", None)
    reqs = gen.generate(spec.requests)
    resumed = False
    if snap_path and os.path.exists(snap_path):
        with open(snap_path) as f:
            snap = json.load(f)
        fe = ServingFrontend.restore(engine, snap, reqs,
                                     snapshot_path=snap_path)
        resumed = True
        print(f"[restart] resumed from {snap_path}: "
              f"readmitted={fe.ledger.readmitted} "
              f"served_before={len(fe.ledger.served)} "
              f"clock={fe.clock.now*1e3:.1f}ms")
    else:
        fe = ServingFrontend(engine, max_batch=spec.max_batch,
                             snapshot_path=snap_path)
    clock = None if resumed else fe.clock
    tracer, activate = _make_tracer(args, clock)
    with activate:
        stats: ServeStats = fe.run(reqs,
                                   max_dispatches=args.kill_after)
    if args.kill_after is not None and fe.pending_requests():
        print(f"[restart] stopped after {args.kill_after} dispatches: "
              f"pending={fe.pending_requests()} snapshot -> {snap_path}; "
              f"rerun the same command to resume")
    _print_traffic(spec, fe, stats)
    return fe, stats, tracer, clock


def _build_registry(stats: ServeStats, server, engine, clock):
    """One MetricsRegistry over every live stats surface of this run:
    engine counters (``serve.``), the server's access-path counters
    (``server.`` — a distinct ServeStats when the engine wraps a
    WeightServer), recovery, prefetch, and the virtual clock."""
    from ..obs import MetricsRegistry
    reg = MetricsRegistry()
    stats.register_into(reg, namespace="serve")
    srv_stats = getattr(server, "stats", None)
    if srv_stats is not None and srv_stats is not stats:
        srv_stats.register_into(reg, namespace="server")
    fault_stats = getattr(getattr(server, "store", None),
                          "fault_stats", None)
    if fault_stats is not None:
        fault_stats.register_into(reg, namespace="recovery")
    pf = getattr(engine, "prefetcher", None)
    if pf is not None:
        reg.register_object(
            "prefetch", pf.stats,
            [f.name for f in dataclasses.fields(pf.stats)])
    if clock is not None:
        reg.gauge("clock.now", lambda c=clock: c.now)
        reg.gauge("clock.channels", lambda c=clock: dict(c.channels))
    return reg


def _export_obs(args, tracer, stats: ServeStats, server, engine,
                clock=None) -> None:
    """--trace / --report-json outputs, after the run completed."""
    if tracer is not None:
        from ..obs import write_trace
        if clock is not None:
            tracer.assert_matches_clock(clock)   # conservation proof
        write_trace(args.trace, tracer, clock=clock)
        print(f"[trace] spans={len(tracer.spans())} "
              f"dropped={tracer.dropped} -> {args.trace}")
    if getattr(args, "report_json", None):
        import json
        reg = _build_registry(stats, server, engine, clock)
        snap = reg.snapshot()
        with open(args.report_json, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[report-json] metrics={len(snap)} -> {args.report_json}")


def _open_db(args, store: ModelStore):
    """Commit the freshly built store to --store-url and reopen it live:
    serving then faults pages from the backend with miss costs charged
    from the backend's own microbenchmark calibration."""
    from ..db import DedupDB
    from ..storage import open_backend
    from ..storage.faults import FaultInjectingBackend, FaultSpec
    # resolve the URL ONCE: a memory-backed objsim:// URL names a fresh
    # store per open_backend() call, so save and reopen must share it
    backend = open_backend(args.store_url)
    if getattr(args, "faults", None):
        backend = FaultInjectingBackend(backend,
                                        FaultSpec.parse(args.faults))
        print(f"[faults] injecting: {backend.spec}")
    store.save(backend)
    db = DedupDB.open(backend, index_mode=args.index_mode)
    storage = db.storage_model()
    print(f"[store-url] {args.store_url} models={len(db.models())} "
          f"pages={db.store.num_pages()} "
          f"calibrated bw={storage.bw/1e6:.0f}MB/s "
          f"seek={storage.seek*1e6:.0f}us")
    return db, storage


def _make_server(args, store: ModelStore, capacity_pages: int
                 ) -> WeightServer:
    """A (possibly sharded) weight server per the CLI flags.  --shards
    N>1 partitions the page pool across N per-shard slabs with the
    selected placement policy; capacity is then PER SHARD (one device's
    slab)."""
    storage = StorageModel(args.storage)
    if args.shards > 1:
        from ..serving.shard_pool import ShardedWeightServer
        from .mesh import shard_devices
        return ShardedWeightServer(
            store, capacity_pages, args.policy, storage, shards=args.shards,
            placement=args.placement, kernel_mode=args.kernel_mode,
            devices=shard_devices(args.shards, args.kernel_mode),
            transfer=args.transfer)
    return WeightServer(store, capacity_pages, args.policy, storage,
                        backend=args.backend, kernel_mode=args.kernel_mode,
                        transfer=args.transfer)


def serve_embedding(args) -> tuple:
    task = SyntheticTextTask(vocab=args.vocab, seed=args.seed)
    store, heads = build_store(task, args.models,
                               index_mode=args.index_mode)
    dedup_bytes = store.storage_bytes()
    dense_bytes = store.dense_bytes()
    print(f"[store] models={args.models} pages={store.num_pages()} "
          f"dense={dense_bytes/2**20:.1f}MiB dedup={dedup_bytes/2**20:.1f}MiB "
          f"reduction={dense_bytes/max(1, dedup_bytes):.2f}x")
    _print_index(store)

    if args.store_url:
        db, _ = _open_db(args, store)
        engine = db.serve_embedding(
            heads, capacity_pages=args.capacity_pages, policy=args.policy,
            scheduler=args.scheduler, overlap=args.overlap,
            prefetch=args.prefetch, compute_backend=args.backend,
            kernel_mode=args.kernel_mode, shards=args.shards,
            placement=args.placement, transfer=args.transfer)
        server = engine.server
    else:
        server = _make_server(args, store, args.capacity_pages)
        engine = EmbeddingServingEngine(
            server, heads, scheduler=args.scheduler,
            prefetcher=Prefetcher(server) if args.prefetch else None,
            overlap=args.overlap)
    if args.traffic:
        spec = TrafficSpec.parse(args.traffic)
        docs_per_req = max(1, args.batch_size // spec.max_batch)
        names = [f"word2vec-v{v}" for v in range(args.models)]

        def _payload(model, rid, rng):
            v = int(model.rsplit("-v", 1)[1])
            docs, _ = task.sample(docs_per_req, variant=v,
                                  seed=args.seed + 100 + rid)
            return docs

        gen = OpenLoopTraffic(names, rate=spec.rate, zipf_alpha=spec.zipf,
                              slo_s=spec.slo_ms * 1e-3, seed=spec.seed,
                              payload_fn=_payload)
        fe, stats, tracer, clock = _run_traffic(args, engine, gen, spec)
    else:
        rng = np.random.default_rng(args.seed + 9)
        for b in range(args.batches):
            v = int(rng.integers(0, args.models))
            name = f"word2vec-v{v}"
            docs, labels = task.sample(args.batch_size, variant=v,
                                       seed=args.seed + 100 + b)
            engine.submit(name, docs)
        clock = None
        tracer, activate = _make_tracer(args)
        with activate:
            stats = engine.run()
    _print_stats(args, stats, server, engine)
    _export_obs(args, tracer, stats, server, engine, clock)
    return stats, server


def serve_lm(args) -> tuple:
    """Reduced-LM variants served with prefill/decode; weights fault in
    through the dedup page pool (and, with --store-url, the backend) at
    every model switch."""
    from ..configs import get_config, reduced
    from ..models import build

    cfg = reduced(get_config("deepseek-7b"))
    num_models = max(2, min(args.models, 3))
    store, names, lm = build_lm_store(cfg, num_models, seed=args.seed,
                                      index_mode=args.index_mode)
    print(f"[store] lm models={num_models} pages={store.num_pages()} "
          f"reduction={store.dense_bytes()/max(1, store.storage_bytes()):.2f}x")
    _print_index(store)

    api = build(cfg)
    apis = {name: api for name in names}
    templates = {name: {"rebuild": lm.rebuild} for name in names}
    # the slab holds one variant's page set unless told otherwise: a
    # model switch pins that set as one group, and on the card a group
    # the slab cannot hold is an error
    cap = args.capacity_pages or max(len(store.model_pages(n))
                                     for n in names)
    if args.store_url:
        db, _ = _open_db(args, store)
        engine = db.serve_lm(apis, templates, capacity_pages=cap,
                             policy=args.policy, scheduler=args.scheduler,
                             overlap=args.overlap, prefetch=args.prefetch,
                             compute_backend=args.backend,
                             kernel_mode=args.kernel_mode,
                             shards=args.shards, placement=args.placement,
                             transfer=args.transfer)
        server = engine.server
    else:
        server = _make_server(args, store, cap)
        engine = LMServingEngine(server, apis, templates,
                                 scheduler=args.scheduler,
                                 overlap=args.overlap)
    if args.traffic:
        spec = TrafficSpec.parse(args.traffic)

        def _payload(model, rid, prng):
            prompts = prng.integers(1, 64, size=(1, 8)).astype(np.int32)
            return prompts, args.lm_steps

        gen = OpenLoopTraffic(names, rate=spec.rate, zipf_alpha=spec.zipf,
                              slo_s=spec.slo_ms * 1e-3, seed=spec.seed,
                              payload_fn=_payload)
        fe, stats, tracer, clock = _run_traffic(args, engine, gen, spec)
    else:
        rng = np.random.default_rng(args.seed)
        for b in range(args.batches):
            name = names[int(rng.integers(0, num_models))]
            prompts = rng.integers(1, 64, size=(2, 8)).astype(np.int32)
            engine.submit(name, prompts, steps=args.lm_steps)
        clock = None
        tracer, activate = _make_tracer(args)
        with activate:
            stats = engine.run()
    _print_stats(args, stats, server, engine)
    _export_obs(args, tracer, stats, server, engine, clock)
    return stats, server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="embedding",
                    choices=("embedding", "lm"),
                    help="embedding: the word2vec multi-model scenario; "
                         "lm: reduced deepseek-7b variants with prefill/"
                         "decode.  Their weights are drawn with numpy from "
                         "--seed (JAX's PRNG cannot be reproduced in "
                         "torch), so they are not the reference CLI's")
    ap.add_argument("--lm-steps", type=int, default=4,
                    help="greedy decode steps per LM batch")
    ap.add_argument("--models", type=int, default=6)
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--capacity-pages", type=int, default=None,
                    help="slab / pool pages (default: 24 for the "
                         "embedding engine; one variant's page set for "
                         "the LM engine)")
    ap.add_argument("--policy", default="optimized_mru")
    ap.add_argument("--storage", default="ssd",
                    choices=list(("ssd", "hdd", "nvme", "dram")))
    ap.add_argument("--store-url", default=None,
                    help="storage backend URL (file:// | sqlite:// | "
                         "objsim://): commit the store there, reopen it "
                         "live, and serve with a microbench-calibrated "
                         "StorageModel instead of the --storage preset")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="chaos mode (requires --store-url): wrap the "
                         "backend in a FaultInjectingBackend with this "
                         "seeded spec, e.g. "
                         "'transient=0.05,corrupt=0.02,seed=7' — the "
                         "recovery layer retries/verifies/re-fetches and "
                         "serving stays bit-exact (DESIGN.md §8)")
    ap.add_argument("--traffic", default=None, metavar="SPEC",
                    help="open-loop request traffic instead of pre-built "
                         "batches: 'rate=200,zipf=1.1,slo_ms=50,seed=0,"
                         "requests=200,max_batch=8' — Poisson arrivals, "
                         "Zipf model popularity, SLO-driven continuous "
                         "batching + cost-based admission through the "
                         "ServingFrontend; prints a [traffic] report "
                         "line (p50/p99/goodput on the virtual clock)")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="warm-restart snapshot (requires --traffic): "
                         "persist the frontend's clock/ledger/queues "
                         "around every dispatch; if PATH exists the run "
                         "RESUMES from it — served requests stay served "
                         "(at-most-once), queued and in-flight ones are "
                         "re-admitted for deterministic recompute "
                         "(DESIGN.md §11)")
    ap.add_argument("--kill-after", type=int, default=None, metavar="N",
                    help="stop after N dispatched batches (requires "
                         "--snapshot): pending work stays in the "
                         "snapshot; rerun the same command to resume")
    ap.add_argument("--scheduler", default="round_robin",
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--backend", default="device",
                    choices=("numpy", "device"),
                    help="device: serve through the device page slab via "
                         "the CUDA dedup kernels (DESIGN.md §3; needs a GPU "
                         "of capability (9, 0)); numpy: host "
                         "materialization (policy simulator)")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES,
                    help="how --backend device computes from the slab: "
                         "cuda = the CUDA kernels (auto = cuda, needs a GPU "
                         "of capability (9, 0)); torch = their plain "
                         "PyTorch versions; host = numpy gathers from the "
                         "slab's host mirror")
    ap.add_argument("--index-mode", default=None,
                    choices=KERNEL_MODES,
                    help="where the store build signs blocks (Alg. 1): "
                         "cuda = the lsh_signature kernel (auto = cuda, "
                         "needs a GPU of capability (9, 0)); torch = its "
                         "plain PyTorch version; host = the reference's "
                         "numpy routine.  Default: --kernel-mode with "
                         "--backend device, host with --backend numpy")
    ap.add_argument("--transfer", default="grouped",
                    choices=("per_page", "grouped"),
                    help="host->device page movement: per_page (one copy "
                         "+ slab update per miss) or grouped (a batch's "
                         "misses coalesce into ONE staged stack, one copy, "
                         "one index_copy_, one remap generation bump; "
                         "DESIGN.md §6)")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the device page pool across N shards "
                         "(per-shard slabs + majority-cover routing + "
                         "cross-shard borrowing; capacity is per shard)")
    ap.add_argument("--placement", default="sharers",
                    choices=("hash", "sharers"),
                    help="page->shard placement: hash-mod baseline, or "
                         "sharer-weighted (replicate hot shared pages, "
                         "partition singletons by model affinity)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffer grouped fetches against compute")
    ap.add_argument("--prefetch", action="store_true",
                    help="lambda-driven page prefetching (implies --overlap:"
                         " speculation only pays off hidden under compute)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a request-path trace and write it here: "
                         "'.json' = Chrome-trace/Perfetto (load in "
                         "chrome://tracing or ui.perfetto.dev), '.jsonl' "
                         "= one flat span dict per line (feed to "
                         "scripts/trace_report.py).  Timestamps are "
                         "virtual-clock microseconds; with --traffic the "
                         "per-channel span time is asserted equal to the "
                         "clock's channel ledger before writing")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="dump a MetricsRegistry snapshot of every stats "
                         "surface (serve/server/recovery/prefetch/clock "
                         "namespaces) as JSON")
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.index_mode is None:
        args.index_mode = args.kernel_mode if args.backend == "device" \
            else "host"
    if args.shards > 1 and args.backend != "device":
        raise SystemExit("--shards > 1 requires --backend device "
                         "(the numpy path has no slabs to partition)")
    if args.prefetch:
        args.overlap = True
    if args.faults and not args.store_url:
        raise SystemExit("--faults requires --store-url (faults inject "
                         "at the storage backend; the in-process store "
                         "has no backend to wrap)")
    if args.snapshot and not args.traffic:
        raise SystemExit("--snapshot requires --traffic (only the "
                         "request-level frontend has restartable state)")
    if args.kill_after is not None and not args.snapshot:
        raise SystemExit("--kill-after requires --snapshot (stopping "
                         "mid-run without a snapshot just loses work)")
    if args.engine == "lm":
        return serve_lm(args)
    if args.capacity_pages is None:
        args.capacity_pages = 24
    return serve_embedding(args)


if __name__ == "__main__":
    main()
