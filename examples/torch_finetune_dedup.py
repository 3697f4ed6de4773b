"""Dedup-aware fine-tuning (paper Sec. 4.3) through the PyTorch / CUDA
port: register two LM variants, freeze the shared blocks via gradient
masks, fine-tune only the private blocks of the second variant on the
card, and show the page store is unchanged for shared pages.  The port's
counterpart of ``examples/finetune_dedup.py``.

    PYTHONPATH=src python examples/torch_finetune_dedup.py
    PYTHONPATH=src python examples/torch_finetune_dedup.py --device cpu

The weights, gradients and masks are torch tensors on the card (the
default; the store's index signs blocks with the ``lsh_signature``
kernel) or, with ``--device cpu``, on the CPU (index mode ``torch``).
The gradients are drawn with numpy from the reference's seed; the last
line counts the kernels' launches.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import DedupConfig, LSHConfig, StoreConfig
from repro_torch.core.device_index import DeviceModelStore
from repro_torch.core.finetune import gradient_masks
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: tensors and the index on the card; cpu: "
                         "on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    device = torch.device(args.device)
    mode = "auto" if args.device == "cuda" else "torch"

    rng = np.random.default_rng(0)
    base = {
        "wq": (rng.standard_normal((256, 256)) * 0.02).astype(np.float32),
        "w1": (rng.standard_normal((256, 512)) * 0.02).astype(np.float32),
    }
    variant = {k: v.copy() for k, v in base.items()}
    variant["w1"][:64] += 0.05        # domain fine-tune touches a corner

    store = DeviceModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(64, 64),
                          lsh=LSHConfig(num_bands=16, rows_per_band=4,
                                        r=2.0, collision_threshold=8),
                          validate=False),
        blocks_per_page=4), index_mode=mode)
    store.register("base", base)
    res = store.register("variant", variant)
    print(f"variant: {res.deduped_blocks}/{res.total_blocks} blocks shared "
          f"with base")

    masks = {k: torch.from_numpy(m).to(device)
             for k, m in gradient_masks(store.dedup, "variant").items()}
    frozen = {k: 1.0 - float(m.mean()) for k, m in masks.items()}
    print("frozen fraction per tensor:",
          {k: f"{v:.2f}" for k, v in frozen.items()})

    # simulated fine-tune steps: masked SGD only updates private blocks
    weights = {k: torch.from_numpy(store.materialize("variant", k)).to(device)
               for k in variant}
    for step in range(5):
        grads = {k: torch.from_numpy(
                     rng.standard_normal(tuple(w.shape)).astype(np.float32)
                     * 0.01).to(device)
                 for k, w in weights.items()}
        for k in weights:
            weights[k] = weights[k] - grads[k] * masks[k]

    tuned = {k: w.cpu().numpy() for k, w in weights.items()}
    for k in tuned:
        shared_region = masks[k].cpu().numpy() == 0
        assert np.array_equal(tuned[k][shared_region],
                              store.materialize("variant", k)[shared_region])
    print("shared blocks bit-identical after fine-tune "
          "(shared pages need no rewrite)")

    # re-register the tuned weights: only private pages change
    before = store.num_pages()
    store.update("variant", tuned, approach=2)
    print(f"pages before/after update: {before}/{store.num_pages()}")
    print(f"[kernels] launches="
          f"{json.dumps(ops.LAUNCHES, separators=(',', ':'))}")


if __name__ == "__main__":
    main()
