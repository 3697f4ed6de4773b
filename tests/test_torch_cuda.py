"""The port's hand-written CUDA kernels on the card.

Every test here needs an NVIDIA GPU of compute capability (9, 0); each
is marked ``cuda`` and skips without one.  The file imports only torch,
numpy and ``repro_torch`` (no JAX), so it runs on a machine with the
card and without the JAX package:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the gather is a pure copy and must be bit-equal; the
product accumulates in fp32 in another order than the plain version,
1e-4 for fp32 and 6e-2 for bf16 inputs (as the reference's
``tests/test_kernels.py``), and is the same bits from call to call;
served logits 1e-5 against the host mode.  Attention: rtol 1e-4 / atol
1e-5 in fp32 (the reference's flash tolerance), 2e-2 in bf16 (p and the
result are each rounded once to bf16).  Each test of a kernel with two
bodies asserts which body ran (``ops.VARIANT_LAUNCHES``).  LSH
signatures: equal except hashes at a bucket edge (``ref.lsh_edges``),
on both bodies (tf32x3 and fma), and the same bits from call to call;
stores built on the card: block maps and pages equal to the host build.
Sharded slab: the kernels at a block map into the staging tail as above;
cuda-mode sharded logits 1e-5 of the host-mode sharded run, its routes
and borrow counters exactly; LM tokens equal to torch mode.  The other
families (fp32, reduced): prefill logits through the kernel route within
1e-4 of the plain attention, greedy tokens equal.  The bf16 split of
an fp32 operand: bit-equal to the plain version; ``dot``'s split3 route
as close to the float64 product as SPLIT_ERR_LIMIT times the FFMA GEMM,
a limit that the GEMMs over x0 alone and over x0 + x1 fail; a few rows
keep the FFMA GEMM.  Training: ``dot``'s
bf16 backward equal to the reference's VJP computed by hand; a bf16
deepseek layer's gradients within cosine 0.99 of fp32's; each wrapper
raises on a CUDA input that needs a gradient, launching nothing.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.data.pipeline import SyntheticTextTask
from repro_torch.db import DedupDB
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import build_lm_store, build_store
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build, layers
from repro_torch.models.layers import dot
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import (EmbeddingServingEngine,
                                        LMServingEngine, StorageModel,
                                        WeightServer)
from repro_torch.tree import leaves_with_path, tree_map

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


#: (dtype, gh, gw, bh, bw, width, B): a ragged last stripe; the word2vec
#: d=300 slab in 64x64 blocks, also at a batch that is not a multiple of
#: the 4 rows (warps) a block and in bf16; more than 32 stripes (the lanes
#: loop over them); rows longer than 32 x 4 vectors; widths that leave
#: 4-byte (fp32, odd width) and 2-byte (bf16, odd width) vectors
GATHER_CASES = [
    (torch.float32, 4, 5, 8, 16, 75, 13),
    (torch.float32, 512, 5, 64, 64, 300, 512),
    (torch.float32, 512, 5, 64, 64, 300, 511),
    (torch.bfloat16, 512, 5, 64, 64, 300, 512),
    (torch.float32, 3, 40, 8, 16, 637, 21),
    (torch.float32, 2, 3, 4, 256, 700, 9),
    (torch.float32, 6, 3, 4, 8, 17, 40),
    (torch.bfloat16, 6, 3, 4, 8, 17, 40),
    (torch.bfloat16, 5, 34, 4, 6, 201, 30),
]


def _gather_check(device, dtype, gh, gw, bh, bw, width, B, bits):
    g = torch.Generator(device=device).manual_seed(0)
    nblk = 11
    pool = torch.randn(nblk, bh, bw, device=device, generator=g).to(dtype)
    bmap = torch.randint(0, nblk, (gh, gw), dtype=torch.int32,
                         device=device, generator=g)
    ids = torch.randint(0, gh * bh, (B,), dtype=torch.int32, device=device,
                        generator=g)
    n0 = ops.LAUNCHES["dedup_embedding"]
    v0 = dict(ops.VARIANT_LAUNCHES["dedup_embedding"])
    got = ops.dedup_embedding_striped(ids, pool, bmap, width=width)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dedup_embedding"] == n0 + 1
    now = ops.VARIANT_LAUNCHES["dedup_embedding"]
    assert {b: now[b] - v0[b] for b in now} == \
        {b: int(b == f"idx{bits}") for b in now}
    assert got.dtype == dtype and got.shape == (B, width)
    assert torch.equal(got, ref.dedup_embedding_striped(ids, pool, bmap,
                                                        width=width))


@pytest.mark.parametrize("dtype,gh,gw,bh,bw,width,B", GATHER_CASES)
def test_striped_gather_bit_exact(cuda_device, dtype, gh, gw, bh, bw, width,
                                  B):
    _gather_check(cuda_device, dtype, gh, gw, bh, bw, width, B, 32)


@pytest.mark.parametrize("dtype,gh,gw,bh,bw,width,B", GATHER_CASES[1:5])
def test_striped_gather_64bit_offsets(cuda_device, monkeypatch, dtype, gh,
                                      gw, bh, bw, width, B):
    """The 64-bit index instance (taken by slabs of 2**31 elements or
    more; forced here) moves the same bits."""
    monkeypatch.setattr(ops, "gather_index_bits", lambda *a: 64)
    _gather_check(cuda_device, dtype, gh, gw, bh, bw, width, B, 64)


def _matmul_inputs(device, dtype, M, bk, bn, nkb, nnb, nd, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, nkb * bk)).astype(
        np.float32)).to(device, dtype)
    pool = torch.from_numpy(rng.standard_normal((nd, bk, bn)).astype(
        np.float32)).to(device, dtype)
    bmap = torch.from_numpy(rng.integers(0, nd, (nkb, nnb)).astype(
        np.int32)).to(device)
    return x, pool, bmap


def _matmul_check(x, pool, bmap, variant):
    before = dict(ops.VARIANT_LAUNCHES["dedup_matmul"])
    got = ops.dedup_matmul(x, pool, bmap)
    torch.cuda.synchronize()
    after = ops.VARIANT_LAUNCHES["dedup_matmul"]
    assert {b: after[b] - before[b] for b in after} == \
        {b: int(b == variant) for b in after}
    assert got.dtype == x.dtype
    want = ref.dedup_matmul(x, pool, bmap)
    tol = 1e-4 if x.dtype == torch.float32 else 6e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,bk,bn,nkb,nnb,nd", MATMUL_SHAPES)
def test_dedup_matmul_matches_plain(cuda_device, dtype, M, bk, bn, nkb, nnb,
                                    nd):
    """The planner's body: wgmma for bf16 at bk % 16 == 0, else fma."""
    x, pool, bmap = _matmul_inputs(cuda_device, dtype, M, bk, bn, nkb, nnb,
                                   nd)
    plan = ops.matmul_plan(M, nkb, nnb, bk, bn, dtype)
    _matmul_check(x, pool, bmap, plan.variant)


@pytest.mark.parametrize("M,bk,bn,nkb,nnb,nd", MATMUL_SHAPES)
def test_dedup_matmul_bf16_on_the_fma_body(cuda_device, monkeypatch, M, bk,
                                           bn, nkb, nnb, nd):
    """bf16 through the CUDA-core body, which the planner keeps for
    depths that are not a multiple of 16 (forced here at every shape)."""
    plan = ops.matmul_plan
    monkeypatch.setattr(ops, "matmul_plan", lambda M, nkb, nnb, bk, bn, dt:
                        plan(M, nkb, nnb, bk, bn, torch.float32))
    x, pool, bmap = _matmul_inputs(cuda_device, torch.bfloat16, M, bk, bn,
                                   nkb, nnb, nd)
    _matmul_check(x, pool, bmap, "fma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dedup_matmul_is_deterministic(cuda_device, dtype):
    """Split-K sums its partials in a fixed order: two calls at the FFNN
    shape (256 blocks, 32 splits) give the same bits."""
    x, pool, bmap = _matmul_inputs(cuda_device, dtype, 64, 64, 64, 32, 4, 40)
    assert ops.matmul_plan(64, 32, 4, 64, 64, dtype).grid[2] == 32
    a = ops.dedup_matmul(x, pool, bmap)
    b = ops.dedup_matmul(x, pool, bmap)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_dedup_matmul_refuses_what_tma_cannot_read(cuda_device):
    """A base address or a row that is not a whole number of 16-byte
    units raises instead of launching."""
    x, pool, bmap = _matmul_inputs(cuda_device, torch.float32, 8, 16, 16, 2,
                                   2, 2)
    n0 = ops.LAUNCHES["dedup_matmul"]
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        ops.dedup_matmul(shifted, pool, bmap)
    narrow = torch.zeros(2, 16, 6, device=cuda_device)      # 24-byte rows
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.dedup_matmul(x, narrow, bmap)
    assert ops.LAUNCHES["dedup_matmul"] == n0


def test_cuda_serving_matches_host(cuda_device):
    """The device path through the CUDA kernels serves the host mode's
    logits, under partial residency and with the double buffer on."""
    task = SyntheticTextTask(vocab=1024, d=72, seed=0)
    store, heads = build_store(task, 3, block_shape=(32, 32),
                               blocks_per_page=4, index_mode="host")
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


FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0.0),
    (1, 32, 48, 4, 4, 8, True, 16, 30.0),     # window + softcap
    (2, 16, 64, 2, 1, 16, False, 0, 0.0),     # cross attention
    (1, 48, 48, 8, 2, 32, True, 0, 50.0),     # GQA + softcap
    (2, 200, 200, 8, 8, 128, True, 0, 0.0),   # ragged tiles, hd 128
    (1, 130, 70, 4, 2, 64, True, 16, 0.0),    # rows with no visible key
    (1, 70, 130, 2, 2, 256, False, 24, 0.0),  # hd 256, non-causal window
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap", FLASH_CASES)
def test_flash_attention_matches_plain(cuda_device, dtype, B, Sq, Skv, H, K,
                                       hd, causal, window, cap):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    n0 = ops.LAUNCHES["flash_attention"]
    v0 = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n0 + 1
    body = ops.flash_variant(dtype, hd)
    assert ops.VARIANT_LAUNCHES["flash_attention"][body] == v0[body] + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


#: bf16 cases of the tensor-core body at head dims 64, 112 (padded to
#: 128), 128 and 256
WGMMA_FLASH_CASES = [
    (1, 256, 256, 4, 1, 128, True, 0, 30.0),    # causal, softcap, GQA 4:1
    (2, 100, 37, 4, 2, 64, False, 0, 0.0),      # cross, ragged Sq and Skv
    (1, 96, 160, 2, 1, 256, True, 32, 50.0),    # window, softcap, GQA
    (1, 150, 40, 2, 2, 128, True, 24, 0.0),     # rows with no visible key
    (1, 64, 64, 2, 2, 112, True, 0, 0.0),       # padded head dim
    (2, 512, 512, 4, 4, 128, True, 0, 0.0),     # the LM prefill, 8 tiles
    (1, 33, 300, 2, 1, 64, False, 0, 0.0),      # the ring wraps 2 times
    (1, 200, 200, 2, 2, 256, True, 64, 0.0),    # tiles skipped at both ends
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap",
                         WGMMA_FLASH_CASES)
def test_flash_attention_wgmma_body(cuda_device, B, Sq, Skv, H, K, hd, causal,
                                    window, cap):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
        for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    v0 = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    now = ops.VARIANT_LAUNCHES["flash_attention"]
    assert (now["wgmma"] - v0["wgmma"], now["fma"] - v0["fma"]) == (1, 0)
    want = ref.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    if window and Sq >= Skv + window:              # no visible key: mean of v
        mean = v.float().mean(dim=1).cpu().numpy()        # [B, K, hd]
        rows = got[:, Skv + window:].reshape(B, -1, K, H // K, hd)
        np.testing.assert_allclose(
            rows, np.broadcast_to(mean[:, None, :, None], rows.shape),
            rtol=2e-2, atol=2e-2)


#: the other families' shapes on both bodies: odd GQA groups (hymba's
#: 25 / 5, arctic's 56 / 8), phi-3-vision's hd 96 and kimi-k2's hd 112 (on
#: the wgmma body, padded to 128), a 1024-key window over 2048 keys with
#: tiles skipped, and whisper's non-causal attention over a ragged 1500
#: keys: its encoder (Sq = Skv) and its cross-attention (Sq = 8)
FAMILY_FLASH_CASES = [
    (1, 300, 300, 10, 2, 64, True, 128, 0.0),     # G 5, window
    (1, 2048, 2048, 5, 1, 64, True, 1024, 0.0),   # hymba's local layer
    (1, 200, 200, 14, 2, 128, True, 0, 0.0),      # G 7
    (1, 256, 256, 4, 4, 96, True, 0, 0.0),        # hd 96
    (1, 256, 256, 8, 1, 112, True, 0, 0.0),       # hd 112, G 8
    (1, 1500, 1500, 2, 2, 64, False, 0, 0.0),     # whisper's encoder
    (1, 8, 1500, 12, 12, 64, False, 0, 0.0),      # whisper's cross
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap",
                         FAMILY_FLASH_CASES)
def test_flash_attention_at_the_families_shapes(cuda_device, dtype, B, Sq,
                                                Skv, H, K, hd, causal,
                                                window, cap):
    """bf16 on the wgmma body (every hd here is a multiple of 16 in
    [64, 256]) and fp32 on the fma body, each against the plain version
    under its tolerance."""
    rng = np.random.default_rng(Sq + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    body = ops.flash_variant(dtype, hd)
    assert body == ("wgmma" if dtype == torch.bfloat16 else "fma")
    v0 = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["flash_attention"][body] == v0[body] + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap)
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


#: fp32 O from bf16 inputs: (body, B, Sq, Skv, H, K, hd, causal, window, cap)
FP32_OUT_CASES = [
    ("wgmma", 1, 130, 130, 4, 2, 64, True, 0, 0.0),
    ("wgmma", 2, 200, 200, 4, 1, 128, True, 0, 30.0),
    ("wgmma", 1, 96, 160, 2, 1, 256, True, 32, 50.0),
    ("wgmma", 1, 150, 40, 2, 2, 128, True, 24, 0.0),   # rows with no key
    ("fma", 1, 130, 130, 4, 2, 128, True, 0, 20.0),
    ("fma", 1, 70, 90, 2, 2, 48, False, 16, 0.0),
]


@pytest.mark.parametrize("body,B,Sq,Skv,H,K,hd,causal,window,cap",
                         FP32_OUT_CASES)
def test_flash_attention_fp32_out(cuda_device, monkeypatch, body, B, Sq, Skv,
                                  H, K, hd, causal, window, cap):
    """bf16 q, k, v with an fp32 O, in both bodies, against the plain
    version's fp32 result: the wgmma body rounds P to bf16 (1e-2, half the
    bf16-out tolerance: O is no longer rounded); the fma body keeps P in
    fp32 (the fp32 tolerance)."""
    monkeypatch.setattr(ops, "flash_variant", lambda dtype, hd: body)
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
        for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    v0 = dict(ops.VARIANT_LAUNCHES["flash_attention"])
    kw = dict(causal=causal, window=window, softcap=cap,
              out_dtype=torch.float32)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["flash_attention"][body] == v0[body] + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = ref.flash_attention(q, k, v, **kw)
    assert want.dtype == torch.float32
    rtol, atol = (1e-2, 1e-2) if body == "wgmma" else (1e-4, 1e-5)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


def test_flash_attention_fp32_input_bf16_out(cuda_device):
    """The fma body also writes an fp32 input's result in bf16."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device)
        for shape in ((1, 70, 4, 32), (1, 70, 2, 32), (1, 70, 2, 32)))
    got = ops.flash_attention(q, k, v, out_dtype=torch.bfloat16)
    want = ref.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=2e-2, atol=2e-2)


def test_prefill_attend_matches_attend_at_the_lm_shape(cuda_device):
    """The model's prefill on the card (the kernel, with the reference's
    roundings: q scaled in fp32 then cast, fp32 O) against the plain
    attend on the card, at the LM shape: q fp32 [4, 512, 32, 128], k and v
    bf16.  They differ only where each rounds p to bf16 (the kernel after
    each 64-key tile's running max, attend after the row's final max), so
    1e-2, half the bf16-out tolerance."""
    from repro_torch.models.attention import attend, prefill_attend
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(4, 512, 32, 128, device=cuda_device, generator=g)
    k, v = (torch.randn(4, 512, 32, 128, device=cuda_device,
                        generator=g).bfloat16() for _ in range(2))
    v0 = ops.VARIANT_LAUNCHES["flash_attention"]["wgmma"]
    got = prefill_attend(q, k, v)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["flash_attention"]["wgmma"] == v0 + 1
    assert got.dtype == torch.float32
    want = attend(q, k, v, causal=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_flash_attention_bf16_on_the_fma_body(cuda_device, monkeypatch):
    """bf16 at head dim 128 through the CUDA-core body (forced), which
    serves the other bf16 head dims."""
    monkeypatch.setattr(ops, "flash_variant", lambda dtype, hd: "fma")
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
        for shape in ((1, 130, 4, 128), (1, 130, 2, 128), (1, 130, 2, 128)))
    v0 = ops.VARIANT_LAUNCHES["flash_attention"]["fma"]
    got = ops.flash_attention(q, k, v, causal=True, softcap=20.0)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["flash_attention"]["fma"] == v0 + 1
    want = ref.flash_attention(q, k, v, causal=True, softcap=20.0)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


#: (rows, cols): 16-byte vectors (widths that are multiples of 8: the
#: deepseek and hymba wo operands', 1000), one value a thread (36, 18, 7)
SPLIT_CASES = [(64, 4096), (48, 1600), (5, 36), (7, 18), (3, 7), (1, 1000)]
#: the split3 route's relative distance from float64, at most this many
#: times the FFMA GEMM's (chip_smoke's SPLIT_ERR_LIMIT)
SPLIT_ERR_LIMIT = 6.0


@pytest.mark.parametrize("rows,cols", SPLIT_CASES)
def test_split_bf16x3_bit_equal_to_plain(cuda_device, rows, cols):
    """The kernel writes the plain version's bits (values over the exact
    exponent range, zeros, inf and NaN), and the parts sum back to x."""
    g = np.random.default_rng(rows * cols)
    x = np.ldexp(g.uniform(1, 2, (rows, cols)) * g.choice([-1, 1],
                                                          (rows, cols)),
                 g.integers(-110, 127, (rows, cols))).astype(np.float32)
    x.reshape(-1)[:4] = [0.0, -0.0, np.inf, np.nan][:x.size]
    x = torch.from_numpy(x).to(cuda_device)
    n0 = ops.LAUNCHES["split_bf16x3"]
    got = ops.split_bf16x3(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["split_bf16x3"] == n0 + 1
    want = ref.split_bf16x3(x)
    assert got.shape == (rows, 3 * cols) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    p = got.float()
    total = (p[:, :cols] + p[:, cols:2 * cols]) + p[:, 2 * cols:]
    fin = torch.isfinite(x)
    assert torch.equal(total[fin].view(torch.int32),
                       x[fin].view(torch.int32))


def _rel_err(y, exact):
    return float((y.double() - exact).norm() / exact.norm())


@pytest.mark.parametrize("M,K,N", [(8192, 4096, 4096), (8192, 1600, 1600)])
def test_dot_split3_route_within_fp32_summation_error(cuda_device, M, K, N):
    """``dot`` of a CUDA fp32 activation of 2M rows and a bf16 weight takes
    the split3 route (one split launch) and lands as close to the float64
    product as SPLIT_ERR_LIMIT times the FFMA GEMM; the GEMMs over x0
    alone and over x0 + x1 of the same split do not.  The shapes are the
    benchmark cells' ``wo`` products: FFMA's own error depends on the
    kernel cuBLAS picks for the shape (a quarter of it at N = 256)."""
    g = torch.Generator(device=cuda_device).manual_seed(K)
    a = torch.randn(2, M, K, device=cuda_device, generator=g)
    b = (torch.randn(K, N, device=cuda_device, generator=g) * 0.02).bfloat16()
    assert layers.dot_route(a, b) == "split3"
    n0 = ops.LAUNCHES["split_bf16x3"]
    got = dot(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["split_bf16x3"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (2, M, N)
    exact = a.double() @ b.double()
    ffma = _rel_err(torch.matmul(a, b.float()), exact)
    assert _rel_err(got, exact) <= SPLIT_ERR_LIMIT * ffma
    s = ops.split_bf16x3(a.reshape(-1, K))              # [x2 | x1 | x0]
    with layers._fp32_reduction():
        x0 = torch.mm(s[:, 2 * K:], b, out_dtype=torch.float32)
        x01 = torch.mm(s[:, K:], torch.cat([b, b]), out_dtype=torch.float32)
    for control in (x0, x01):
        assert _rel_err(control.reshape(2, M, N), exact) \
            > SPLIT_ERR_LIMIT * ffma


def test_dot_of_a_few_rows_takes_no_split(cuda_device):
    """A decode step's product (a few rows) keeps the FFMA GEMM: no split
    launch, the same result as ``torch.matmul`` in fp32."""
    a = torch.randn(4, 1, 256, device=cuda_device)
    w = torch.randn(256, 64, device=cuda_device).bfloat16()
    assert layers.dot_route(a, w) == "fp32"
    n0 = ops.LAUNCHES["split_bf16x3"]
    got = dot(a, w)
    assert ops.LAUNCHES["split_bf16x3"] == n0
    assert torch.equal(got, torch.matmul(a, w.float()))


def test_dot_with_a_gradient_takes_no_split(cuda_device):
    """Training's fp32 x bf16 products (operands that need a gradient)
    stay on the fp32 route: no split launch, a gradient flows."""
    a = torch.randn(layers.SPLIT_MIN_ROWS, 64, device=cuda_device,
                    requires_grad=True)
    w = torch.randn(64, 16, device=cuda_device).bfloat16()
    n0 = ops.LAUNCHES["split_bf16x3"]
    dot(a, w).sum().backward()
    assert ops.LAUNCHES["split_bf16x3"] == n0
    assert a.grad is not None


def test_bf16_dot_accumulates_in_fp32(cuda_device):
    """models.layers.dot on bf16 operands writes fp32, equal to the
    product of the widened operands up to summation order."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn(3, 5, 256, device=cuda_device, generator=g).bfloat16()
    b = torch.randn(256, 96, device=cuda_device, generator=g).bfloat16()
    got = dot(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("arch", list_archs())
def test_family_prefill_cuda_matches_torch_mode(cuda_device, arch):
    """Each reduced family in fp32 on the card: prefill through the
    kernel route (flash_attention's fma body, non-causal for whisper's
    encoder and cross-attention) against the plain attention, logits
    within 1e-4, then three decode steps with equal greedy tokens."""
    from repro_torch.models import encdec, transformer
    cfg = reduced(get_config(arch))
    tree = encdec.init_params(cfg, 0, max_dec=64) if cfg.encdec \
        else transformer.init_params(cfg, 0)
    lm = convert.lm_tensors(tree, dtype=cfg.dtype)
    params = lm.rebuild(lm.tensors, device=cuda_device)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, size=(2, 24)).astype(np.int32)).to(cuda_device)}
    if cfg.encdec:
        batch["frames"] = torch.randn(2, 40, cfg.d_model, device=cuda_device)
    if cfg.vlm_stub:
        batch["image_embeds"] = torch.randn(2, cfg.num_patches, cfg.d_model,
                                            device=cuda_device)
    max_len = 28 + (cfg.num_patches if cfg.vlm_stub else 0)
    out = {}
    for attention in ("kernel", "plain"):
        api = build(cfg, attention=attention)
        n0 = ops.LAUNCHES["flash_attention"]
        logits, cache = api.prefill(params, batch, max_len)
        launches = ops.LAUNCHES["flash_attention"] - n0
        first = logits.cpu().numpy()
        toks = [logits.argmax(-1)]
        for _ in range(3):
            logits, cache = api.decode(params, cache, toks[-1])
            toks.append(logits.argmax(-1))
        out[attention] = (launches, first, torch.cat(toks, 1).cpu().numpy())
    # one launch an attention of the prompt: each layer's self-attention,
    # and whisper's encoder layers and cross-attentions
    want = 0 if cfg.family == "ssm" else cfg.num_layers \
        + (cfg.enc_layers + cfg.num_layers if cfg.encdec else 0)
    assert out["kernel"][0] == want and out["plain"][0] == 0
    np.testing.assert_allclose(out["kernel"][1], out["plain"][1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(out["kernel"][2], out["plain"][2])


def _lm_setup():
    cfg = reduced(get_config("deepseek-7b"))
    store, names, lm = build_lm_store(cfg, 2, seed=0, index_mode="host")
    apis = {m: build(cfg) for m in names}
    plain = {m: build(cfg, attention="plain") for m in names}
    templates = {m: {"rebuild": lm.rebuild} for m in names}
    return store, names, apis, plain, templates


def test_lm_engine_cuda_matches_torch_mode(cuda_device):
    """The LM engine in cuda mode (slab on the card, flash_attention
    kernel) serves the greedy tokens of the torch mode on the card (plain
    attention) from one store; prefill goes through the kernel."""
    store, names, apis, plain, templates = _lm_setup()
    prompts = np.random.default_rng(4).integers(
        1, 256, size=(2, 40)).astype(np.int32)
    out = {}
    for mode, a in (("cuda", apis), ("torch", plain)):
        server = WeightServer(store, store.num_pages(),
                              storage=StorageModel("dram"), kernel_mode=mode,
                              device=cuda_device)
        engine = LMServingEngine(server, a, templates)
        n0 = ops.LAUNCHES["flash_attention"]
        toks = [engine.generate(m, prompts, steps=5)[0] for m in names]
        launches = ops.LAUNCHES["flash_attention"] - n0
        assert engine.stats.device_batches == 2
        assert engine.stats.dense_fallbacks == 0
        assert launches == (4 if mode == "cuda" else 0)
        out[mode] = toks
    for a, b in zip(out["cuda"], out["torch"]):
        np.testing.assert_array_equal(a, b)


def test_lm_engine_cuda_mode_raises_without_room(cuda_device):
    """A slab too small for a variant's page set no longer raises in cuda
    mode, and never materializes on the host: the switch comes through
    the staging tail (counted in ``dense_fallbacks``, as the reference
    counts its host fallback), with torch mode's tokens at that slab."""
    store, names, apis, plain, templates = _lm_setup()

    def refuse(*a, **k):
        raise AssertionError("materialized on the host")
    prompts = np.ones((1, 8), np.int32)
    out = {}
    for mode, a in (("cuda", apis), ("torch", plain)):
        server = WeightServer(store, 2, storage=StorageModel("dram"),
                              kernel_mode=mode, device=cuda_device)
        engine = LMServingEngine(server, a, templates)
        store.materialize = refuse
        try:
            out[mode] = engine.generate(names[0], prompts, steps=2)[0]
        finally:
            del store.materialize
        assert engine.stats.dense_fallbacks == 1
        assert engine.stats.device_batches == 0
        assert server.device_pool.tail_calls > 0
    np.testing.assert_array_equal(out["cuda"], out["torch"])


#: the reference's three shapes, the LM stores' (64x64 blocks, 64 hashes,
#: r = 0.25; 32x32, 16 hashes, r = 4), and ragged n, dim and nh
LSH_SHAPES = [(16, 64, 16, 2.0), (33, 100, 24, 4.0), (128, 512, 128, 1.0),
              (256, 4096, 64, 0.25), (256, 1024, 16, 4.0),
              (1000, 4096, 64, 0.25), (65, 1000, 70, 0.7),
              (50, 256, 264, 1.0), (40, 36, 6, 2.0), (40, 1001, 16, 1.0),
              (30, 64, 9, 2.0)]


def _lsh_inputs(device, n, dim, nh, r, seed=3):
    rng = np.random.default_rng(seed)
    scale = 0.02 if dim >= 1024 else 1.0
    blocks = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    proj = rng.standard_normal((dim, nh)).astype(np.float32)
    bias = (rng.random(nh) * r).astype(np.float32)
    return blocks, proj, bias, [torch.from_numpy(a).to(device)
                                for a in (blocks, proj, bias)]


def _lsh_check(device, n, dim, nh, r, body):
    blocks, proj, bias, (x, p, b) = _lsh_inputs(device, n, dim, nh, r)
    n0 = ops.LAUNCHES["lsh_signature"]
    v0 = dict(ops.VARIANT_LAUNCHES["lsh_signature"])
    got = ops.lsh_signature(x, p, b, r)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lsh_signature"] == n0 + 1
    now = ops.VARIANT_LAUNCHES["lsh_signature"]
    assert {k: now[k] - v0[k] for k in now} == \
        {k: int(k == body) for k in now}
    assert got.dtype == torch.int32 and got.shape == (n, nh)
    edges = ref.lsh_edges(x, p, b, r).cpu().numpy()
    got = got.cpu().numpy()
    for want in (ref.lsh_signature(x, p, b, r).cpu().numpy(),
                 np.floor((blocks @ proj + bias) / r).astype(np.int32)):
        assert not ((got != want) & ~edges).any()


@pytest.mark.parametrize("n,dim,nh,r", LSH_SHAPES)
def test_lsh_signature_matches_plain(cuda_device, n, dim, nh, r):
    """Equal to the plain version and to numpy except hashes whose exact
    value lies within 1e-4 of a bucket edge (ref.lsh_edges): the floor
    turns a last-bit difference of summation order into a bucket.  The
    body is the one ops.lsh_variant picks: tf32x3 but at dim 1001 and
    nh 9 (nh 70 and 264 end in a ragged 64-hash tile, nh 6 fills one
    partly)."""
    _lsh_check(cuda_device, n, dim, nh, r, ops.lsh_variant(n, dim, nh))


@pytest.mark.parametrize("n,dim,nh,r", LSH_SHAPES)
def test_lsh_signature_on_the_fma_body(cuda_device, monkeypatch, n, dim, nh,
                                       r):
    """The CUDA-core body (forced at every shape) under the same
    criterion."""
    monkeypatch.setattr(ops, "lsh_variant", lambda n, dim, nh: "fma")
    _lsh_check(cuda_device, n, dim, nh, r, "fma")


def test_lsh_signature_tf32x3_is_deterministic(cuda_device):
    """Two tf32x3 calls at the LM stores' width give the same bits."""
    *_, (x, p, b) = _lsh_inputs(cuda_device, 1000, 4096, 64, 0.25)
    assert ops.lsh_variant(1000, 4096, 64) == "tf32x3"
    first = ops.lsh_signature(x, p, b, 0.25)
    second = ops.lsh_signature(x, p, b, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_lsh_signature_refuses_a_misaligned_base(cuda_device):
    """TMA reads the blocks: a base address that is not 16-byte aligned
    raises on the tf32x3 body instead of launching."""
    *_, (x, p, b) = _lsh_inputs(cuda_device, 64, 256, 16, 1.0)
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x)
    shifted.copy_(x)
    n0 = ops.LAUNCHES["lsh_signature"]
    with pytest.raises(ValueError, match="aligned"):
        ops.lsh_signature(shifted, p, b, 1.0)
    assert ops.LAUNCHES["lsh_signature"] == n0


def test_dedup_db_cuda_build_matches_host(cuda_device, tmp_path):
    """DedupDB.register and a reopened store's update sign on the card
    and give the host build's block maps and pages."""
    task = SyntheticTextTask(vocab=2048, d=72, seed=3)
    new = task.variant_embedding(1).copy()
    new[:600] += np.random.default_rng(7).standard_normal(
        (600, 72)).astype(np.float32)
    built, updated = {}, {}
    for mode in ("cuda", "host"):
        store, _ = build_store(task, 4, block_shape=(32, 32),
                               blocks_per_page=4, index_mode=mode)
        url = f"sqlite:///{tmp_path / f'{mode}.db'}"
        built[mode] = store.save(url)["pages"]
        db = DedupDB.open(url, index_mode=mode)
        n0 = ops.LAUNCHES["lsh_signature"]
        db.update("word2vec-v1", {"embedding": new})
        launches = ops.LAUNCHES["lsh_signature"] - n0
        assert launches == (0 if mode == "host" else
                            db.store.dedup.index_stats.launches)
        assert launches >= (2 if mode == "cuda" else 0)
        updated[mode] = ({m: r.tensors["embedding"].block_map
                          for m, r in db.store.dedup.models.items()},
                         db.commit()["pages"])
        db.close()
    assert built["cuda"] == built["host"]
    assert updated["cuda"][1] == updated["host"][1]
    for m, bm in updated["host"][0].items():
        np.testing.assert_array_equal(updated["cuda"][0][m], bm)


# ------------------------------------------------------- sharded slab --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_read_a_staging_tail(cuda_device, dtype):
    """The sharded path's new input: a block map pointing past
    ``capacity`` into the borrow-staging tail, over a slab longer than
    ``capacity`` (pages of 8 64x64 blocks).  The gather stays bit-exact
    (on the idx32 instance), the product within 1e-4 fp32 / 6e-2 bf16 on
    its planned body (fma / wgmma)."""
    cap, stage, l = 20, 12, 8
    g = torch.Generator(device=cuda_device).manual_seed(5)
    pool = torch.randn((cap + stage) * l, 64, 64, device=cuda_device,
                       generator=g).to(dtype)
    lo, hi = cap * l, (cap + stage) * l
    bmap = torch.randint(0, hi, (40, 5), dtype=torch.int32,
                         device=cuda_device, generator=g)
    bmap[::2] = torch.randint(lo, hi, (20, 5), dtype=torch.int32,
                              device=cuda_device, generator=g)
    bmap[-1, -1] = hi - 1                        # the tail's last block
    ids = torch.randint(0, 40 * 64, (512,), dtype=torch.int32,
                        device=cuda_device, generator=g)
    v0 = dict(ops.VARIANT_LAUNCHES["dedup_embedding"])
    got = ops.dedup_embedding_striped(ids, pool, bmap, width=300)
    torch.cuda.synchronize()
    assert ops.VARIANT_LAUNCHES["dedup_embedding"]["idx32"] == v0["idx32"] + 1
    assert torch.equal(got, ref.dedup_embedding_striped(ids, pool, bmap,
                                                        width=300))
    wmap = torch.randint(lo, hi, (32, 4), dtype=torch.int32,
                         device=cuda_device, generator=g)
    wmap[:, 0] = torch.randint(0, lo, (32,), dtype=torch.int32,
                               device=cuda_device, generator=g)
    x = torch.randn(64, 2048, device=cuda_device, generator=g).to(dtype)
    _matmul_check(x, pool, wmap,
                  ops.matmul_plan(64, 32, 4, 64, 64, dtype).variant)


def _sharded_scenario():
    task = SyntheticTextTask(vocab=2048, d=72, seed=0)
    store, heads = build_store(task, 4, block_shape=(32, 32),
                               blocks_per_page=4, index_mode="host")
    batches = [(f"word2vec-v{b % 4}",
                task.sample(16, variant=b % 4, seed=300 + b)[0])
               for b in range(8)]
    return store, heads, batches


def _sharded_server(store, kernel_mode, placement="hash", **kw):
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.serving import ShardedWeightServer
    return ShardedWeightServer(store, store.num_pages(),
                               storage=StorageModel("dram"), shards=2,
                               placement=placement, kernel_mode=kernel_mode,
                               devices=shard_devices(2, kernel_mode), **kw)


@pytest.mark.parametrize("tail", [None, 1])
def test_staging_tail_chunks_match_torch_mode(cuda_device, monkeypatch,
                                              tail):
    """Past the slab (a quarter of the store, below each batch's pages),
    cuda mode serves every batch through the staging tail -- at the
    default tail, and at a 1-page tail a page a chunk -- with torch
    mode's logits (1e-5) and pool decisions, one ``dedup_embedding``
    launch a chunk; the FFNN-shaped product past the slab within 1e-4 of
    numpy in K ranges."""
    from repro_torch.serving import device_pool
    if tail is not None:
        monkeypatch.setattr(device_pool, "TAIL_PAGES", tail)
    store, heads, batches = _sharded_scenario()
    cap = store.num_pages() // 4
    runs = {}
    for km in ("torch", "cuda"):
        srv = WeightServer(store, cap, storage=StorageModel("dram"),
                           kernel_mode=km, device=cuda_device)
        engine = EmbeddingServingEngine(srv, heads, scheduler="fifo",
                                        overlap=True)
        n0 = ops.LAUNCHES["dedup_embedding"]
        out = []
        for model, docs in batches:
            engine.submit(model, docs)
            engine.run(max_batches=1)
            out.append(engine.last_logits.copy())
        pool = srv.device_pool
        runs[km] = (out, engine.stats.dense_fallbacks, pool.loads,
                    pool.evicts, pool.tail_calls, pool.tail_chunks,
                    ops.LAUNCHES["dedup_embedding"] - n0)
    for a, b in zip(runs["torch"][0], runs["cuda"][0]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert runs["cuda"][1:6] == runs["torch"][1:6]
    assert runs["cuda"][1] == runs["cuda"][4] == len(batches)
    assert runs["cuda"][6] == runs["cuda"][5]
    assert runs["torch"][6] == 0
    # the product: W [640, 200] over 32x32 blocks, a third of its pages
    rng = np.random.default_rng(5)
    w = rng.standard_normal((640, 200)).astype(np.float32)
    x = rng.standard_normal((16, 640)).astype(np.float32)
    from repro_torch.core import (DedupConfig, LSHConfig, ModelStore,
                                  StoreConfig)
    fstore = ModelStore(StoreConfig(
        dedup=DedupConfig(block_shape=(32, 32),
                          lsh=LSHConfig(num_bands=8, rows_per_band=2, r=4.0,
                                        collision_threshold=6),
                          validate=False),
        blocks_per_page=4))
    fstore.register("f", {"W": w})
    cap = max(1, len(fstore.model_pages("f")) // 3)
    srv = WeightServer(fstore, cap, storage=StorageModel("dram"),
                       kernel_mode="cuda", device=cuda_device)
    srv.access_pages("f", fstore.model_pages("f"))
    n0 = ops.LAUNCHES["dedup_matmul"]
    y = srv.device_matmul("f", "W", x).cpu().numpy()
    np.testing.assert_allclose(y, x @ w, rtol=1e-4, atol=1e-4)
    assert ops.LAUNCHES["dedup_matmul"] - n0 == srv.device_pool.tail_chunks
    assert srv.device_pool.tail_calls == 1


def test_sharded_cuda_serving_matches_host(cuda_device):
    """2 shards in cuda mode serve the host-mode sharded run's logits
    (1e-5), with its routes and borrow counters exactly; under hash the
    gather reads staged blocks from the tail."""
    store, heads, batches = _sharded_scenario()
    for placement in ("hash", "sharers"):
        runs = {}
        for km in ("host", "cuda"):
            srv = _sharded_server(store, km, placement)
            engine = EmbeddingServingEngine(srv, heads, overlap=True,
                                            scheduler="fifo")
            n0 = ops.LAUNCHES["dedup_embedding"]
            out = []
            for model, docs in batches:
                engine.submit(model, docs)
                engine.run(max_batches=1)
                out.append(engine.last_logits.copy())
                srv.sharded.check_invariants()
            assert engine.stats.device_batches == len(batches)
            assert engine.stats.dense_fallbacks == 0
            s = srv.stats
            runs[km] = (out, dict(s.shard_batches), s.borrow_pages,
                        s.borrow_mirror_hits, s.borrow_store_faults,
                        s.borrow_coalesced, dict(srv.sharded.tail_reads))
            if km == "cuda":
                assert ops.LAUNCHES["dedup_embedding"] - n0 == len(batches)
        if placement == "hash":
            assert runs["cuda"][2] > 0
            assert runs["cuda"][6]["gather_rows"] > 0
        for a, b in zip(runs["host"][0], runs["cuda"][0]):
            np.testing.assert_allclose(a, b, atol=1e-5)
        assert runs["host"][1:] == runs["cuda"][1:]


def test_sharded_cuda_mode_raises_on_an_oversized_borrow_set(cuda_device):
    """A borrow set the staging tail cannot hold no longer raises in cuda
    mode, and is never served on the host: it goes through the shard's
    overflow rows, with the host-mode run's logits (1e-5) and counters."""
    store, heads, batches = _sharded_scenario()
    runs = {}
    for km in ("host", "cuda"):
        srv = _sharded_server(store, km, borrow_capacity=1)
        engine = EmbeddingServingEngine(srv, heads, scheduler="fifo")
        out = []
        for model, docs in batches:
            engine.submit(model, docs)
            engine.run(max_batches=1)
            out.append(engine.last_logits.copy())
        runs[km] = (out, engine.stats.dense_fallbacks,
                    engine.stats.device_batches, srv.sharded.tail_calls)
    for a, b in zip(runs["host"][0], runs["cuda"][0]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert runs["cuda"][1:] == runs["host"][1:]
    assert runs["cuda"][1] > 0 and runs["cuda"][3] == runs["cuda"][1]


def test_sharded_transfer_snapshot_resolves_device_seconds(cuda_device):
    """``transfer_snapshot`` over 2 shards folds every shard's CUDA-event
    timings: no timer is left pending, and the device seconds, pages and
    bytes are the shards' sums."""
    store, heads, batches = _sharded_scenario()
    srv = _sharded_server(store, "cuda", "sharers")
    engine = EmbeddingServingEngine(srv, heads, overlap=True,
                                    scheduler="fifo")
    for model, docs in batches:
        engine.submit(model, docs)
    engine.run()
    snap = srv.transfer_snapshot()
    pools = srv.sharded.pools
    assert all(not p.transfer._timers for p in pools)
    assert snap["pages"] == sum(p.transfer.stats.pages for p in pools) > 0
    assert snap["bytes"] == sum(p.transfer.stats.bytes for p in pools)
    assert snap["seconds"] == pytest.approx(
        sum(p.transfer.stats.seconds for p in pools))
    assert snap["seconds"] > 0.0
    assert engine.stats.transfer_seconds > 0.0


def test_sharded_lm_engine_cuda_matches_torch_mode(cuda_device):
    """The LM engine over 2 hash-placed shards in cuda mode (tensors
    reassembled from a slab and its staging tail, prefill through
    flash_attention) gives the greedy tokens of the torch mode on the
    card."""
    from repro_torch.serving import ShardedWeightServer
    store, names, apis, plain, templates = _lm_setup()
    cap = max(len(store.model_pages(n)) for n in names)
    prompts = np.random.default_rng(4).integers(
        1, 256, size=(2, 40)).astype(np.int32)
    out = {}
    for mode, a in (("cuda", apis), ("torch", plain)):
        srv = ShardedWeightServer(store, cap, storage=StorageModel("dram"),
                                  shards=2, placement="hash",
                                  kernel_mode=mode,
                                  devices=[cuda_device] * 2)
        engine = LMServingEngine(srv, a, templates)
        out[mode] = [engine.generate(m, prompts, steps=5)[0] for m in names]
        assert engine.stats.dense_fallbacks == 0
        assert srv.stats.borrow_pages > 0
        assert srv.sharded.tail_reads["unblock"] > 0
    for a, b in zip(out["cuda"], out["torch"]):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- training --
def test_dot_bf16_backward_is_the_reference_vjp(cuda_device):
    """``dot`` of bf16 operands on the card (fp32 out) has a gradient, and
    it is the reference's VJP: the fp32 cotangent times the other operand
    widened to fp32, rounded once to bf16."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 150, 512, generator=g).to(cuda_device, torch.bfloat16)
    b = torch.randn(512, 384, generator=g).to(cuda_device, torch.bfloat16)
    cot = torch.randn(2, 150, 384, generator=g).to(cuda_device)
    a.requires_grad_()
    b.requires_grad_()
    out = dot(a, b)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    out.backward(cot)
    c2 = cot.reshape(-1, 384)
    a2 = a.detach().reshape(-1, 512)
    assert torch.equal(a.grad.reshape(-1, 512),
                       (c2 @ b.detach().float().T).to(torch.bfloat16))
    assert torch.equal(b.grad, (a2.float().T @ c2).to(torch.bfloat16))


def test_bf16_deepseek_layer_gradients_track_fp32(cuda_device):
    """One deepseek-7b layer at full width (d 4096, 32 heads of 128, d_ff
    11008; vocabulary cut to 512) in bf16 and in fp32 from the same
    (bf16-rounded) weights: every gradient leaf within cosine 0.99 of the
    fp32 one, and the loss launched no kernel (it runs the plain
    attention, whatever ``attention=`` says)."""
    cfg = dataclasses.replace(get_config("deepseek-7b"), num_layers=1,
                              vocab=512)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = convert.train_params(init_params(cfg, 0), bf16, cuda_device)
    p32 = tree_map(lambda t: t.detach().float().requires_grad_(), p16)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, (1, 129)).astype(
        np.int32)).to(cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = []
    ops.reset_launches()
    for c, params in ((bf16, p16),
                      (dataclasses.replace(cfg, dtype="float32"), p32)):
        api = build(c)
        loss, g = value_and_grad(lambda p: api.loss(p, batch), params)
        assert bool(torch.isfinite(loss))
        grads.append(g)
    assert sum(ops.LAUNCHES.values()) == 0
    for (path, gb), (_, gf) in zip(leaves_with_path(grads[0]),
                                   leaves_with_path(grads[1])):
        assert gb.dtype == (torch.float32 if path[-1] in convert.F32_LEAVES
                            else torch.bfloat16)
        a, b = gb.float().flatten(), gf.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.99, (path, cos)


@pytest.mark.parametrize("name", sorted(ops.LAUNCHES))
def test_kernel_wrappers_refuse_inputs_that_need_grad_on_the_card(
        cuda_device, name):
    dev = cuda_device
    pool = torch.randn(4, 64, 64, device=dev, requires_grad=True)
    bmap = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=dev)
    q = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    blocks = torch.randn(8, 64, device=dev, requires_grad=True)
    calls = {
        "dedup_matmul": lambda: ops.dedup_matmul(
            torch.randn(3, 128, device=dev), pool, bmap),
        "dedup_embedding": lambda: ops.dedup_embedding(
            torch.tensor([0, 9], dtype=torch.int32, device=dev), pool,
            torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)),
        "flash_attention": lambda: ops.flash_attention(q, kv, kv),
        "lsh_signature": lambda: ops.lsh_signature(
            blocks, torch.randn(64, 4, device=dev),
            torch.zeros(4, device=dev), 1.0),
        "split_bf16x3": lambda: ops.split_bf16x3(blocks),
    }
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="requires grad"):
        calls[name]()
    assert ops.LAUNCHES == before


# ---------------------------------------------------------- distribution --
@pytest.fixture
def one_rank_nccl(cuda_device):
    """A one-rank NCCL default group for the test, torn down after."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield cuda_device
    if owned:
        dist.destroy_process_group()


def test_mm_dtype_on_a_one_rank_cuda_mesh(one_rank_nccl):
    """``torch.mm(a, b, out_dtype=F32)`` of bf16 DTensors on a (1, 1)
    ``("data", "model")`` cuda mesh (the strategy the port registers):
    bit-equal to the product without a mesh, also through ``dot``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import P, placements
    from repro_torch.models.layers import dot
    dev = one_rank_nccl
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(96, 256, device=dev, generator=g).to(torch.bfloat16)
    b = torch.randn(256, 80, device=dev, generator=g).to(torch.bfloat16)
    A = distribute_tensor(a, mesh, placements(P("data", None), mesh))
    B = distribute_tensor(b, mesh, placements(P("data", "model"), mesh))
    want = torch.mm(a, b, out_dtype=torch.float32)
    got = torch.mm(A, B, out_dtype=torch.float32).full_tensor()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    got = dot(A.reshape(4, 24, 256), B).full_tensor()
    assert torch.equal(got.reshape(96, 80), want)


def test_pipeline_apply_on_the_card(cuda_device):
    """``pipeline_apply`` on ``cuda:0``: a reduced bf16 deepseek's layers
    in 2 stages through the ``flash_attention`` kernel, 3 microbatches:
    bit-equal to the unpipelined forward of each microbatch, one launch a
    layer a microbatch."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced(get_config("deepseek-7b")),
                              dtype="bfloat16", head_dim=64)
    L = cfg.num_layers
    params = convert.train_params(transformer.init_params(cfg, 3), cfg,
                                  cuda_device)
    (g,) = transformer.build_groups(cfg)
    half = transformer.GroupSpec(g.name, g.kind, L // 2, g.windows[:L // 2])
    pos = torch.arange(64, device=cuda_device)[None, :]
    with torch.no_grad():
        blocks = tree_map(lambda t: t.detach(), params[g.name])
        x = torch.randn(3, 1, 64, cfg.d_model, device=cuda_device).to(
            torch.bfloat16)
        stages = [tree_map(lambda a, s=s: a[s * (L // 2):(s + 1) * (L // 2)],
                           blocks) for s in range(2)]
        n0 = ops.LAUNCHES["flash_attention"]
        out = pipeline_apply(
            lambda p, h: transformer._run_group(h, p, half, cfg, pos, True),
            stages, x)
        assert ops.LAUNCHES["flash_attention"] - n0 == L * 3
        ref = torch.stack([transformer._run_group(x[m], blocks, g, cfg, pos,
                                                  True) for m in range(3)])
    assert out.device.type == "cuda" and torch.equal(out, ref)


def test_stacked_slab_on_the_card_mesh(one_rank_nccl):
    """``stacked_slab(make_shard_mesh(2))`` in cuda mode: a DTensor on the
    one-rank NCCL serving mesh, its local tensor the per-shard stack."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.mesh import make_shard_mesh
    store, heads, batches = _sharded_scenario()
    srv = _sharded_server(store, "cuda", "sharers")
    engine = EmbeddingServingEngine(srv, heads, overlap=True,
                                    scheduler="fifo")
    for model, docs in batches[:4]:
        engine.submit(model, docs)
        engine.run(max_batches=1)
    mesh = make_shard_mesh(2)
    assert mesh.device_type == "cuda" and mesh.size() == 1
    slab = srv.sharded.stacked_slab(mesh)
    assert isinstance(slab, DTensor) and tuple(slab.placements) == (Shard(0),)
    assert slab.to_local().device.type == "cuda"
    assert torch.equal(slab.to_local(), srv.sharded.stacked_slab())
