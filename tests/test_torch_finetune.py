"""The port's copies of ``core/finetune.py`` (dedup-aware fine-tuning,
paper Sec. 4.3) and ``core/compress.py`` (composition with pruning and
quantization, Sec. 7.6.2, Tab. 9).

Ports of ``tests/test_finetune.py`` and of
``tests/test_system.py::test_compression_composition_table9`` on the
port's ``Deduplicator`` / ``ModelStore``, and the same masks and
compressed tensors as the JAX package's on the same inputs.
"""
import numpy as np

from repro.core.compress import prune_model as jprune_model
from repro.core.compress import quantize_model as jquantize_model
from repro.core.dedup import DedupConfig as JDedupConfig
from repro.core.dedup import Deduplicator as JDeduplicator
from repro.core.finetune import gradient_masks as jgradient_masks
from repro.core.lsh import LSHConfig as JLSHConfig
from repro_torch.core import ModelStore, StoreConfig, check_coverage
from repro_torch.core.blocks import block_tensor
from repro_torch.core.compress import prune_model, quantize_model
from repro_torch.core.dedup import DedupConfig, Deduplicator
from repro_torch.core.finetune import (apply_masks, gradient_mask,
                                       gradient_masks, private_block_mask)
from repro_torch.core.lsh import LSHConfig, estimate_r
from repro_torch.data.pipeline import SyntheticTextTask


def _pair_arrays():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((32, 32)).astype(np.float32)
    var = base.copy()
    var[:8, :8] += 5.0                      # one clearly-private block
    return base, var


def _dedup_pair(config=DedupConfig, lsh=LSHConfig, dedup=Deduplicator):
    cfg = config(block_shape=(8, 8),
                 lsh=lsh(num_bands=8, rows_per_band=2, r=8.0,
                         collision_threshold=6),
                 validate=False)
    d = dedup(cfg)
    base, var = _pair_arrays()
    d.add_model("base", {"w": base})
    d.add_model("var", {"w": var})
    return d, base, var


def test_private_mask_marks_only_private_blocks():
    d, base, var = _dedup_pair()
    mask = private_block_mask(d, "var", "w")
    bm = d.models["var"].tensors["w"].block_map
    for bid, m in enumerate(mask):
        owners = d.owners[int(bm[bid])]
        models = {mm for (mm, _t) in owners}
        assert (m == 1.0) == (models == {"var"})


def test_gradient_mask_freezes_shared_blocks():
    d, base, var = _dedup_pair()
    gm = gradient_mask(d, "var", "w")
    assert gm.shape == (32, 32)
    # the perturbed block is private -> trainable
    assert gm[:8, :8].min() == 1.0
    # shared blocks frozen
    assert gm.mean() < 1.0
    grads = {"w": np.ones((32, 32), np.float32)}
    masked = apply_masks(grads, gradient_masks(d, "var"))
    assert np.array_equal(masked["w"], gm)


def test_finetune_preserves_shared_pages():
    """Simulated fine-tune: masked updates leave shared blocks bit-equal."""
    d, base, var = _dedup_pair()
    gm = gradient_mask(d, "var", "w")
    current = d.materialize("var", "w")
    updated = current - 0.1 * gm * np.ones_like(current)
    assert np.array_equal(updated[gm == 0], current[gm == 0])
    assert not np.array_equal(updated[gm == 1], current[gm == 1])


def test_gradient_masks_equal_the_reference():
    d, _, _ = _dedup_pair()
    jd, _, _ = _dedup_pair(JDedupConfig, JLSHConfig, JDeduplicator)
    for model in ("base", "var"):
        got, want = gradient_masks(d, model), jgradient_masks(jd, model)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def _task_store(num_models=3, seed=7):
    """``tests/test_system.py``'s store on the port: the synthetic word
    embedding's variants in 32x32 blocks, 4 a page, no validation."""
    task = SyntheticTextTask(vocab=1024, d=32, seed=seed)
    blocks, _ = block_tensor(task.base_embed, (32, 32))
    store = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=16, rows_per_band=4,
                                        r=estimate_r(blocks, quantile=0.5),
                                        collision_threshold=8),
                          validate=False, validate_every_k=8,
                          accuracy_drop_threshold=0.035),
        blocks_per_page=4))
    for v in range(num_models):
        store.register(f"v{v}", {"embedding": task.variant_embedding(v)})
    return task, store


def test_compression_composition_table9():
    """Dedup composes with pruning/quantization (Sec. 7.6.2)."""
    task, store = _task_store(num_models=3, seed=7)
    base_pages = store.num_pages()
    check_coverage(store.repack(), store.dedup.tensor_sets(), 4)

    store_q = ModelStore(store.cfg)
    for v in range(3):
        store_q.register(f"v{v}", quantize_model(
            {"embedding": task.variant_embedding(v)}))
    # quantization snaps values -> dedup keeps working
    assert store_q.num_pages() <= base_pages * 1.2

    store_p = ModelStore(store.cfg)
    for v in range(3):
        store_p.register(f"v{v}", prune_model(
            {"embedding": task.variant_embedding(v)}, 0.5))
    assert store_p.num_pages() <= base_pages * 1.2


def test_compression_equals_the_reference():
    task = SyntheticTextTask(vocab=256, d=32, seed=1)
    emb = {"embedding": task.variant_embedding(1)}
    for got, want in ((quantize_model(emb), jquantize_model(emb)),
                      (prune_model(emb, 0.5), jprune_model(emb, 0.5))):
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
