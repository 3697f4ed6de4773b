"""Quickstart through the PyTorch / CUDA port: deduplicate three
fine-tuned embedding models, pack them into pages, reconstruct them,
and serve them out of SQLite — the paper's Fig.-3 pipeline, the port's
counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card (the default) the ``DeviceModelStore`` signs every block
with the ``lsh_signature`` kernel and the slab serves through
``dedup_embedding``; ``--device cpu`` runs their plain PyTorch versions
(kernel and index mode ``torch``).  The slab holds 4 of the store's 5
pages, as the reference's does: switching variants evicts, and a batch
whose pages the slab could not hold would come through its staging
tail (the ``device:`` line counts both; the ``[kernels]`` line, the
kernels' launches).  The database goes to the temporary directory
(``TMPDIR``).
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import DedupConfig, LSHConfig, StoreConfig
from repro_torch.core.blocks import block_tensor
from repro_torch.core.device_index import DeviceModelStore
from repro_torch.core.lsh import estimate_r
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels on the card; cpu: "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)
    mode = "auto" if args.device == "cuda" else "torch"

    rng = np.random.default_rng(0)
    base = (rng.standard_normal((1024, 128)) * 0.05).astype(np.float32)

    # three fine-tuned variants of one pretrained weight matrix
    variants = {}
    for v in range(3):
        delta = np.zeros_like(base)
        rows = rng.choice(1024, 80, replace=False)       # light fine-tune
        delta[rows] = rng.standard_normal((80, 128)).astype(np.float32) * 0.02
        variants[f"model-v{v}"] = {"weights": base + delta}

    # configure: L2-LSH index (Sec. 4) + two-stage page packing (Sec. 5)
    blocks, _ = block_tensor(base, (64, 64))
    cfg = StoreConfig(
        dedup=DedupConfig(block_shape=(64, 64),
                          lsh=LSHConfig(num_bands=16, rows_per_band=4,
                                        r=estimate_r(blocks, quantile=0.5),
                                        collision_threshold=8),
                          validate=False),
        blocks_per_page=8, pack_strategy="two_stage")
    store = DeviceModelStore(cfg, index_mode=mode)

    for name, tensors in variants.items():
        res = store.register(name, tensors)
        print(f"registered {name}: {res.deduped_blocks}/{res.total_blocks} "
              f"blocks deduplicated")

    pk = store.repack()
    print(f"\npages: {pk.num_pages} ({pk.num_shared_pages()} shared)")
    print(f"dense storage : {store.dense_bytes() / 2**20:.2f} MiB")
    print(f"dedup storage : {store.storage_bytes() / 2**20:.2f} MiB "
          f"({store.dense_bytes() / store.storage_bytes():.2f}x reduction)")

    # reconstruct and check
    for name, tensors in variants.items():
        rec = store.materialize(name, "weights")
        err = np.abs(rec - tensors["weights"]).max()
        print(f"{name}: max reconstruction err {err:.4f}")

    # persist into a relational database — the paper's native habitat —
    # then reopen it as a live DedupDB and serve straight out of it
    from repro_torch.db import DedupDB

    path = os.path.join(tempfile.gettempdir(),
                        "repro_torch_quickstart_models.db")
    url = f"sqlite:///{path}"
    store.save(url)                       # pages as BLOBs + relational manifest
    print(f"\ncommitted store to {url}")

    db = DedupDB.open(url, index_mode=mode)   # live: pages stay in the DB
    for name in variants:
        rec = db.store.materialize(name, "weights")   # faults pages lazily
        assert np.array_equal(rec, store.materialize(name, "weights"))
    print(f"reopened {len(db.models())} models from SQLite, bit-exact")

    # one-call serving: buffer pool + scheduler + microbench-calibrated
    # storage clock, wired by the facade; the slab is on the card
    heads = {name: rng.standard_normal((128, 8)).astype(np.float32)
             for name in variants}
    engine = db.serve_embedding(heads, embed_tensor="weights",
                                capacity_pages=4, kernel_mode=mode)
    for name in variants:
        engine.submit(name, rng.integers(0, 1024, size=(4, 16)))
    stats = engine.run()
    print(f"served {stats.batches} batches from the database "
          f"(hit ratio {engine.server.pool.hit_ratio:.2f})")
    print(f"device: {stats.device_batches} batches on the slab, "
          f"{stats.dense_fallbacks} through its staging tail "
          f"({engine.server.device_pool.mode()})")
    print(f"[kernels] launches="
          f"{json.dumps(ops.LAUNCHES, separators=(',', ':'))}")


if __name__ == "__main__":
    main()
