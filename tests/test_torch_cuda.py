"""The port's hand-written CUDA kernels on the card.

Every test here needs an NVIDIA GPU of compute capability (9, 0); each
is marked ``cuda`` and skips without one.  The file imports only torch,
numpy and ``repro_torch`` (no JAX), so it runs on a machine with the
card and without the JAX package:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the gather is a pure copy and must be bit-equal; the
product accumulates in IEEE fp32 in another order than the plain
version, 1e-4 for fp32 and 6e-2 for bf16 inputs (as the reference's
``tests/test_kernels.py``); served logits 1e-5 against the host mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import build_store
from repro_torch.serving.engine import (EmbeddingServingEngine, StorageModel,
                                        WeightServer)

pytestmark = pytest.mark.cuda

MATMUL_SHAPES = [
    (32, 16, 16, 2, 2, 2),
    (64, 32, 64, 3, 2, 4),
    (100, 16, 128, 2, 3, 3),        # ragged M
    (16, 64, 32, 1, 4, 1),          # single distinct block
    (64, 64, 64, 32, 4, 40),        # the FFNN W1 shape, [2048, 256]
    (7, 24, 72, 3, 2, 5),           # ragged block depth and width
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("gh,gw,bh,bw,width,B", [
    (4, 5, 8, 16, 75, 13),          # ragged last stripe
    (512, 5, 64, 64, 300, 512),     # word2vec d=300 in 64x64 blocks
    (6, 3, 4, 8, 17, 40),           # odd width: narrow vectors
])
def test_striped_gather_bit_exact(cuda_device, gh, gw, bh, bw, width, B):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    nblk = 11
    pool = torch.randn(nblk, bh, bw, device=cuda_device, generator=g)
    bmap = torch.randint(0, nblk, (gh, gw), dtype=torch.int32,
                         device=cuda_device, generator=g)
    ids = torch.randint(0, gh * bh, (B,), dtype=torch.int32,
                        device=cuda_device, generator=g)
    n0 = ops.LAUNCHES["dedup_embedding"]
    got = ops.dedup_embedding_striped(ids, pool, bmap, width=width)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dedup_embedding"] == n0 + 1
    assert torch.equal(got, ref.dedup_embedding_striped(ids, pool, bmap,
                                                        width=width))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,bk,bn,nkb,nnb,nd", MATMUL_SHAPES)
def test_dedup_matmul_matches_plain(cuda_device, dtype, M, bk, bn, nkb, nnb,
                                    nd):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((M, nkb * bk)).astype(
        np.float32)).to(cuda_device, dtype)
    pool = torch.from_numpy(rng.standard_normal((nd, bk, bn)).astype(
        np.float32)).to(cuda_device, dtype)
    bmap = torch.from_numpy(rng.integers(0, nd, (nkb, nnb)).astype(
        np.int32)).to(cuda_device)
    got = ops.dedup_matmul(x, pool, bmap)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    want = ref.dedup_matmul(x, pool, bmap)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def test_cuda_serving_matches_host(cuda_device):
    """The device path through the CUDA kernels serves the host mode's
    logits, under partial residency and with the double buffer on."""
    task = SyntheticTextTask(vocab=1024, d=72, seed=0)
    store, heads = build_store(task, 3, block_shape=(32, 32),
                               blocks_per_page=4)
    batches = [(f"word2vec-v{b % 3}",
                task.sample(16, variant=b % 3, seed=100 + b)[0])
               for b in range(6)]
    # half the pages, but at least one batch's pinned page group
    planner = WeightServer(store, 2, backend="numpy")
    cap = max(store.num_pages() // 2,
              max(len(planner.embedding_rows_pages(m, "embedding",
                                                   np.unique(d)))
                  for m, d in batches))
    assert cap < store.num_pages()               # pages still churn
    logits = {}
    for km in ("host", "cuda"):
        server = WeightServer(store, cap, storage=StorageModel("dram"),
                              kernel_mode=km)
        engine = EmbeddingServingEngine(server, heads, overlap=True,
                                        scheduler="fifo")
        out = []
        for model, docs in batches:
            engine.submit(model, docs)
        for _ in range(6):
            engine.run(max_batches=1)
            out.append(engine.last_logits.copy())
        assert engine.stats.device_batches == 6
        assert engine.stats.dense_fallbacks == 0
        logits[km] = out
    for a, b in zip(logits["host"], logits["cuda"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
