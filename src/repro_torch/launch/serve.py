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
with the CUDA kernels and needs an NVIDIA GPU of capability (9, 0);
``--backend numpy`` is the host simulator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --models 6 --batches 60
  PYTHONPATH=src python -m repro_torch.launch.serve --backend numpy
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --store-url sqlite:////tmp/m.db
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import DedupConfig, LSHConfig, ModelStore, StoreConfig
from ..core.lsh import estimate_r
from ..data.pipeline import SyntheticTextTask
from ..serving.engine import (EmbeddingServingEngine, ServeStats,
                              StorageModel, WeightServer)
from ..serving.prefetch import Prefetcher
from ..serving.scheduler import SCHEDULERS


def build_store(task: SyntheticTextTask, num_models: int,
                block_shape=(64, 64), blocks_per_page: int = 8,
                pack_strategy: str = "two_stage"):
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
    store = ModelStore(cfg)
    heads = {}
    for v in range(num_models):
        name = f"word2vec-v{v}"
        emb = task.variant_embedding(v)
        store.register(name, {"embedding": emb})
        heads[name] = task.train_head(emb, variant=v)
    return store, heads


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
    db = DedupDB.open(backend)
    storage = db.storage_model()
    print(f"[store-url] {args.store_url} models={len(db.models())} "
          f"pages={db.store.num_pages()} "
          f"calibrated bw={storage.bw/1e6:.0f}MB/s "
          f"seek={storage.seek*1e6:.0f}us")
    return db, storage


def serve_embedding(args) -> tuple:
    task = SyntheticTextTask(vocab=args.vocab, seed=args.seed)
    store, heads = build_store(task, args.models)
    dedup_bytes = store.storage_bytes()
    dense_bytes = store.dense_bytes()
    print(f"[store] models={args.models} pages={store.num_pages()} "
          f"dense={dense_bytes/2**20:.1f}MiB dedup={dedup_bytes/2**20:.1f}MiB "
          f"reduction={dense_bytes/max(1, dedup_bytes):.2f}x")

    if args.store_url:
        db, _ = _open_db(args, store)
        engine = db.serve_embedding(
            heads, capacity_pages=args.capacity_pages, policy=args.policy,
            scheduler=args.scheduler, overlap=args.overlap,
            prefetch=args.prefetch, compute_backend=args.backend,
            transfer=args.transfer)
        server = engine.server
    else:
        server = WeightServer(store, args.capacity_pages, args.policy,
                              StorageModel(args.storage),
                              backend=args.backend,
                              transfer=args.transfer)
        engine = EmbeddingServingEngine(
            server, heads, scheduler=args.scheduler,
            prefetcher=Prefetcher(server) if args.prefetch else None,
            overlap=args.overlap)
    rng = np.random.default_rng(args.seed + 9)
    for b in range(args.batches):
        v = int(rng.integers(0, args.models))
        name = f"word2vec-v{v}"
        docs, labels = task.sample(args.batch_size, variant=v,
                                   seed=args.seed + 100 + b)
        engine.submit(name, docs)
    stats = engine.run()
    _print_stats(args, stats, server, engine)
    return stats, server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", type=int, default=6)
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--capacity-pages", type=int, default=24)
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
    ap.add_argument("--scheduler", default="round_robin",
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--backend", default="device",
                    choices=("numpy", "device"),
                    help="device: serve through the device page slab via "
                         "the CUDA dedup kernels (DESIGN.md §3; needs a GPU "
                         "of capability (9, 0)); numpy: host "
                         "materialization (policy simulator)")
    ap.add_argument("--transfer", default="grouped",
                    choices=("per_page", "grouped"),
                    help="host->device page movement: per_page (one copy "
                         "+ slab update per miss) or grouped (a batch's "
                         "misses coalesce into ONE staged stack, one copy, "
                         "one index_copy_, one remap generation bump; "
                         "DESIGN.md §6)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffer grouped fetches against compute")
    ap.add_argument("--prefetch", action="store_true",
                    help="lambda-driven page prefetching (implies --overlap:"
                         " speculation only pays off hidden under compute)")
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.prefetch:
        args.overlap = True
    if args.faults and not args.store_url:
        raise SystemExit("--faults requires --store-url (faults inject "
                         "at the storage backend; the in-process store "
                         "has no backend to wrap)")
    return serve_embedding(args)


if __name__ == "__main__":
    main()
