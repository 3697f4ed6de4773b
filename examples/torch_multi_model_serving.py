"""End-to-end serving run (the paper's kind: SERVING) through the PyTorch /
CUDA port: batched requests across six word2vec-style model variants,
served out of the deduplicated page store through the Eq.-2 buffer pool
and the device slab, with accuracy verification.  The port's counterpart
of ``examples/multi_model_serving.py``.

    PYTHONPATH=src python examples/torch_multi_model_serving.py
    PYTHONPATH=src python examples/torch_multi_model_serving.py --device cpu

On the card (the default) the store's index is signed by the
``lsh_signature`` kernel and every batch is gathered by
``dedup_embedding``; ``--device cpu`` runs their plain PyTorch versions
(kernel and index mode ``torch``).  The pool holds half the store's
pages, as the reference's does; a batch whose pages it could not hold
would be served through the slab's staging tail (each run's ``device``
line counts both kinds; the last line, the kernels' launches).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.launch.serve import build_store
from repro_torch.kernels import ops
from repro_torch.serving import (BatchComputeModel, EmbeddingServingEngine,
                                 OpenLoopTraffic, Prefetcher, ServingFrontend,
                                 StorageModel, WeightServer)


def serve_once(store, heads, task, mode, *, scheduler, overlap, prefetch,
               label):
    # memory-pressured pool on simulated SSD, Eq.-2-aware eviction
    server = WeightServer(store, capacity_pages=store.num_pages() // 2,
                          policy="optimized_mru",
                          storage=StorageModel("ssd", jitter=0.5,
                                               hedge_after=0.002),
                          kernel_mode=mode)
    engine = EmbeddingServingEngine(
        server, heads, scheduler=scheduler,
        prefetcher=Prefetcher(server) if prefetch else None,
        overlap=overlap)

    rng = np.random.default_rng(1)
    eval_sets = {}
    for b in range(80):
        v = int(rng.integers(0, 6))
        docs, labels = task.sample(32, variant=v, seed=100 + b)
        eval_sets[b] = (f"word2vec-v{v}", docs, labels)
        engine.submit(f"word2vec-v{v}", docs)
    stats = engine.run()

    print(f"[{label}]")
    print(f"  served {stats.requests} requests in {stats.batches} batches")
    print(f"  cache hit ratio : {server.pool.hit_ratio:.3f}")
    print(f"  virtual I/O time: {stats.fetch_seconds * 1e3:.2f} ms demand "
          f"+ {stats.prefetch_seconds * 1e3:.2f} ms prefetch")
    print(f"  compute time    : {stats.compute_seconds * 1e3:.2f} ms")
    print(f"  end-to-end      : {stats.makespan_seconds * 1e3:.2f} ms")
    print(f"  p50 / p99       : {stats.percentile(50) * 1e3:.2f} / "
          f"{stats.percentile(99) * 1e3:.2f} ms")
    print(f"  device          : {stats.device_batches} batches on the slab, "
          f"{stats.dense_fallbacks} through its staging tail "
          f"({server.device_pool.mode()})")
    return stats, eval_sets


def serve_traffic(store, heads, task, mode, *, rate, label):
    """Open-loop request traffic (Poisson arrivals, Zipf popularity)
    through the SLO-driven frontend: individual requests arrive over
    virtual time, merge into batches under a 25ms SLO, and hopeless
    requests are shed instead of served dead-on-arrival."""
    server = WeightServer(store, capacity_pages=store.num_pages() // 2,
                          policy="optimized_mru",
                          storage=StorageModel("ssd"), kernel_mode=mode)
    engine = EmbeddingServingEngine(server, heads, scheduler="fifo",
                                    overlap=True)

    def payload(model, rid, rng):
        v = int(model.rsplit("-v", 1)[1])
        docs, _ = task.sample(4, variant=v, seed=10_000 + rid)
        return docs

    gen = OpenLoopTraffic([f"word2vec-v{v}" for v in range(6)],
                          rate=rate, zipf_alpha=1.1, slo_s=0.025,
                          seed=7, payload_fn=payload)
    frontend = ServingFrontend(engine, max_batch=8,
                               compute_model=BatchComputeModel())
    stats = frontend.run(gen.generate(160))
    served = len(stats.request_latencies)
    print(f"[{label}]")
    print(f"  offered {stats.offered_requests} requests at {rate:g}/s, "
          f"served {served}, shed {stats.shed_requests}, "
          f"missed SLO {stats.slo_misses}")
    print(f"  goodput         : {stats.goodput:.3f}")
    if served:
        print(f"  request p50/p99 : "
              f"{stats.request_percentile(50) * 1e3:.2f} / "
              f"{stats.request_percentile(99) * 1e3:.2f} ms")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels on the card; cpu: "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)
    mode = "auto" if args.device == "cuda" else "torch"

    task = SyntheticTextTask(vocab=2048, d=64, seed=0)
    store, heads = build_store(task, num_models=6, index_mode=mode)
    print(f"store: {store.num_pages()} pages, "
          f"{store.dense_bytes() / store.storage_bytes():.2f}x reduction")

    serial, eval_sets = serve_once(
        store, heads, task, mode, scheduler="round_robin", overlap=False,
        prefetch=False, label="serial round-robin (baseline)")
    asynch, _ = serve_once(
        store, heads, task, mode, scheduler="dedup_affinity", overlap=True,
        prefetch=True, label="async dedup-affinity + prefetch")
    print(f"end-to-end speedup: "
          f"{serial.makespan_seconds / asynch.makespan_seconds:.2f}x")

    serve_traffic(store, heads, task, mode, rate=2000,
                  label="open-loop traffic @ 2000 req/s, 25ms SLO")

    # verify served accuracy against the deduplicated weights
    correct = total = 0
    for b, (name, docs, labels) in eval_sets.items():
        emb = store.materialize(name, "embedding")
        pred = (emb[docs].mean(axis=1) @ heads[name]).argmax(axis=1)
        correct += int((pred == labels).sum())
        total += len(labels)
    print(f"accuracy        : {correct / total:.3f}")
    print(f"[kernels] launches="
          f"{json.dumps(ops.LAUNCHES, separators=(',', ':'))}")


if __name__ == "__main__":
    main()
