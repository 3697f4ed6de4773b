"""The port's dedup kernels against the JAX package's.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the
plain PyTorch versions; they are held against ``repro.kernels.ref`` and
against the Pallas kernels in interpret mode (``repro.kernels.ops``), on
the same numpy inputs and over the shapes of ``tests/test_kernels.py``.
Tolerances: 1e-4 for fp32 and 6e-2 for bf16 products (summation order
differs), 1e-6 / exact for gathers (a pure copy).  The hand-written
kernels themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref

torch.set_num_threads(2)

RNG = np.random.default_rng(0)

MATMUL_SHAPES = [
    (32, 16, 16, 2, 2, 2),
    (64, 32, 64, 3, 2, 4),
    (100, 16, 128, 2, 3, 3),        # ragged M
    (16, 64, 32, 1, 4, 1),          # single distinct block (full dedup)
]


def _tol(dt):
    return 1e-4 if dt == "float32" else 6e-2


def _inputs(dtype, M, bk, bn, nkb, nnb, nd, rng):
    """fp32 arrays whose values are exact in ``dtype`` (bf16 rounded via
    ml_dtypes, so numpy, JAX and torch all see the same numbers)."""
    x = rng.standard_normal((M, nkb * bk)).astype(np.float32)
    pool = rng.standard_normal((nd, bk, bn)).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        pool = pool.astype(ml_dtypes.bfloat16).astype(np.float32)
    bmap = rng.integers(0, nd, (nkb, nnb)).astype(np.int32)
    return x, pool, bmap


def _tt(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


# ------------------------------------------------------------ dedup_matmul --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,bk,bn,nkb,nnb,nd", MATMUL_SHAPES)
def test_dedup_matmul_matches_jax(dtype, M, bk, bn, nkb, nnb, nd):
    x, pool, bmap = _inputs(dtype, M, bk, bn, nkb, nnb, nd, RNG)
    y = ops.dedup_matmul(_tt(x, dtype), _tt(pool, dtype), _tt(bmap, "int32"))
    assert y.dtype == getattr(torch, dtype)
    assert y.shape == (M, nnb * bn)
    jx = jnp.asarray(x, dtype)
    jp = jnp.asarray(pool, dtype)
    yr = jref.dedup_matmul(jx, jp, jnp.asarray(bmap))
    yk = jops.dedup_matmul(jx, jp, jnp.asarray(bmap), bm=16)
    got = y.float().numpy()
    for want in (yr, yk):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=_tol(dtype), atol=_tol(dtype))


def test_dedup_matmul_batched_lead_dims():
    x = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    pool = RNG.standard_normal((3, 16, 16)).astype(np.float32)
    bmap = RNG.integers(0, 3, (2, 2)).astype(np.int32)
    y = ops.dedup_matmul(_tt(x), _tt(pool), _tt(bmap, "int32"))
    assert y.shape == (2, 5, 32)
    want = jref.dedup_matmul(jnp.asarray(x), jnp.asarray(pool),
                             jnp.asarray(bmap))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_materialize_virtual_matches_jax():
    pool = RNG.standard_normal((4, 16, 8)).astype(np.float32)
    bmap = RNG.integers(0, 4, (3, 5)).astype(np.int32)
    got = ref.materialize_virtual(_tt(pool), _tt(bmap, "int32"), 40, 37)
    want = jref.materialize_virtual(jnp.asarray(pool), jnp.asarray(bmap),
                                    40, 37)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- dedup_embedding --
@pytest.mark.parametrize("V,bv,D,B", [(64, 8, 32, 7), (128, 16, 64, 33)])
def test_dedup_embedding_matches_jax(V, bv, D, B):
    pool = RNG.standard_normal((5, bv, D)).astype(np.float32)
    rbmap = RNG.integers(0, 5, (V // bv,)).astype(np.int32)
    ids = RNG.integers(0, V, (B,)).astype(np.int32)
    e = ops.dedup_embedding(_tt(ids, "int32"), _tt(pool), _tt(rbmap, "int32"))
    expect = np.stack([pool[rbmap[i // bv]][i % bv] for i in ids])
    np.testing.assert_allclose(e.numpy(), expect, rtol=1e-6)
    jk = jops.dedup_embedding(jnp.asarray(ids), jnp.asarray(pool),
                              jnp.asarray(rbmap))
    np.testing.assert_allclose(e.numpy(), np.asarray(jk), rtol=1e-6)
    plain = ref.dedup_embedding(_tt(ids, "int32"), _tt(pool),
                                _tt(rbmap, "int32"), D - 3)
    jplain = jref.dedup_embedding(jnp.asarray(ids), jnp.asarray(pool),
                                  jnp.asarray(rbmap), D - 3)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jplain))


@pytest.mark.parametrize("gh,gw,bh,bw,width,B", [
    (4, 5, 8, 16, 75, 13),          # ragged last stripe (75 of 80)
    (3, 1, 16, 32, 32, 9),          # one stripe, full width
    (6, 3, 4, 8, 17, 40),           # narrow ragged stripe
])
def test_striped_gather_matches_jax(gh, gw, bh, bw, width, B):
    nblk = 7
    pool = RNG.standard_normal((nblk, bh, bw)).astype(np.float32)
    bmap = RNG.integers(0, nblk, (gh, gw)).astype(np.int32)
    ids = RNG.integers(0, gh * bh, (B,)).astype(np.int32)
    got = ops.dedup_embedding_striped(_tt(ids, "int32"), _tt(pool),
                                      _tt(bmap, "int32"), width=width)
    want = jops.dedup_embedding_striped(jnp.asarray(ids), jnp.asarray(pool),
                                        jnp.asarray(bmap), width=width)
    assert got.shape == (B, width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_wrappers_launch_no_kernel():
    """A CPU tensor takes the plain version: no launch is counted, by
    kernel or by body."""
    before = dict(ops.LAUNCHES)
    bodies = {k: dict(v) for k, v in ops.VARIANT_LAUNCHES.items()}
    ops.dedup_embedding_striped(_tt(np.zeros(4, np.int32), "int32"),
                                torch.zeros(2, 4, 8),
                                _tt(np.zeros((1, 1), np.int32), "int32"))
    for dt in (torch.float32, torch.bfloat16):
        ops.dedup_matmul(torch.zeros(3, 64, dtype=dt),
                         torch.zeros(1, 64, 64, dtype=dt),
                         _tt(np.zeros((1, 1), np.int32), "int32"))
        ops.flash_attention(torch.zeros(1, 4, 2, 128, dtype=dt),
                            torch.zeros(1, 4, 1, 128, dtype=dt),
                            torch.zeros(1, 4, 1, 128, dtype=dt))
    assert ops.LAUNCHES == before
    assert ops.VARIANT_LAUNCHES == bodies


def test_reset_launches_clears_the_body_counts():
    ops.VARIANT_LAUNCHES["flash_attention"]["wgmma"] += 3
    ops.VARIANT_LAUNCHES["lsh_signature"]["tf32x3"] += 2
    ops.VARIANT_LAUNCHES["lsh_signature"]["fma"] += 1
    ops.VARIANT_LAUNCHES["dedup_embedding"]["idx64"] += 1
    ops.LAUNCHES["dedup_matmul"] += 1
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}
    assert all(n == 0 for v in ops.VARIANT_LAUNCHES.values()
               for n in v.values())


# ------------------------------------------------- the planners (pure) --
@pytest.mark.parametrize("dtype,bk,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 24, "fma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 16, "fma"),
])
def test_matmul_plan_body(dtype, bk, body):
    """bf16 takes the tensor cores where wgmma's k of 16 divides the
    storage depth; fp32 stays in IEEE fp32 on the CUDA cores."""
    plan = ops.matmul_plan(64, 4, 2, bk, 64, dtype)
    assert plan.variant == body
    assert plan.tile == ((64, 32) if body == "wgmma" else (32, 64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_plan_fills_the_card_at_the_ffnn_shape(dtype):
    """x [64, 2048] @ W1 [2048, 256] in 64x64 blocks: one storage block a
    split, 32 splits, at least 256 blocks, an fp32 [32, 64, 256]
    workspace."""
    plan = ops.matmul_plan(64, 32, 4, 64, 64, dtype)
    assert plan.blocks >= 256
    assert plan.grid[2] == 32 and plan.per_split == 1
    assert plan.workspace == (32, 64, 256)


@pytest.mark.parametrize("M,nkb,nnb,bk,bn", [
    (1, 7, 1, 16, 16), (100, 3, 3, 16, 128), (7, 3, 2, 24, 72),
    (64, 10, 1, 64, 64), (4096, 32, 4, 64, 64), (33, 100, 5, 32, 40),
])
def test_matmul_plan_splits(M, nkb, nnb, bk, bn):
    """Runs of equal length, none empty, covering every storage block;
    at least 2 x 132 blocks where K allows, one split (no workspace)
    where the tiles alone fill the card."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = ops.matmul_plan(M, nkb, nnb, bk, bn, dtype)
        tm, tn = plan.tile
        tiles = -(-M // tm) * nnb * -(-bn // tn)
        assert plan.grid[:2] == (-(-M // tm), nnb * -(-bn // tn))
        splits, per = plan.grid[2], plan.per_split
        assert 1 <= splits <= nkb
        assert per * (splits - 1) < nkb <= per * splits
        assert plan.blocks >= min(2 * ops.H100_SMS, tiles * nkb)
        assert (plan.workspace is None) == (splits == 1)
        if splits > 1:
            assert plan.workspace == (splits, M, nnb * bn)
        # the fewest splits that runs of equal length allow
        want = -(-2 * ops.H100_SMS // tiles)
        counts = {-(-nkb // p) for p in range(1, nkb + 1)}
        assert splits == min((c for c in counts if c >= want), default=nkb)
        assert per == -(-nkb // splits)


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 8, "fma"),
    (torch.bfloat16, 72, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"),
])
def test_flash_variant(dtype, hd, body):
    """The tensor-core body takes bf16 at a head dim that is a multiple
    of 16 in [64, 256]; fp32 keeps the CUDA-core body (its 1e-4
    tolerance), and so do the other bf16 head dims."""
    assert ops.flash_variant(dtype, hd) == body


@pytest.mark.parametrize("n,dim,nh,body", [
    (16, 64, 16, "tf32x3"), (33, 100, 24, "tf32x3"), (128, 512, 128, "tf32x3"),
    (256, 4096, 64, "tf32x3"), (256, 1024, 16, "tf32x3"),
    (1000, 4096, 64, "tf32x3"), (65, 1000, 70, "tf32x3"),
    (50, 256, 264, "tf32x3"), (40, 36, 6, "tf32x3"), (40, 1001, 16, "fma"),
    (30, 64, 9, "fma"),
    (8, 4098, 64, "fma"), (8, 4096, 264, "tf32x3"), (8, 4096, 256, "tf32x3"),
    (8, 36, 4, "tf32x3"),
])
def test_lsh_variant(n, dim, nh, body):
    """The tensor-core body where TMA can stride the blocks and the
    workspace (dim % 4 == 0) and the epilogue stores int32 pairs (nh % 2
    == 0), at any number of 64-hash tiles; the CUDA-core body elsewhere.
    The first eleven are the card tests' LSH_SHAPES: dim 1001 and nh 9
    go to fma."""
    assert ops.lsh_variant(n, dim, nh) == body


@pytest.mark.parametrize("pool_numel,out_numel,bits", [
    (2568 * 64 * 64, 512 * 300, 32), (2 ** 31 - 1, 2 ** 31 - 1, 32),
    (2 ** 31, 10, 64), (10, 2 ** 31, 64), (3 * 2 ** 31, 2 ** 33, 64),
])
def test_gather_index_bits(pool_numel, out_numel, bits):
    """32-bit offsets while the slab and the output both hold fewer than
    2**31 elements."""
    assert ops.gather_index_bits(pool_numel, out_numel) == bits


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: building a kernel raises instead of falling back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.BuildError):
        _build.load("dedup_embedding")


def test_meta_tensor_has_no_kernel():
    """Only CPU (plain) and CUDA (kernel) tensors are taken."""
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.dedup_embedding_striped(ids, torch.zeros(2, 4, 8, device="meta"),
                                    torch.zeros(1, 1, dtype=torch.int32,
                                                device="meta"))
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])


# --------------------------------------------------------- flash_attention --
FLASH_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0.0),
    (1, 32, 48, 4, 4, 8, True, 16, 30.0),     # window + softcap
    (2, 16, 64, 2, 1, 16, False, 0, 0.0),     # cross attention
    (1, 48, 48, 8, 2, 32, True, 0, 50.0),     # GQA + softcap
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,cap", FLASH_CASES)
def test_flash_attention_matches_jax(B, Sq, Skv, H, K, hd, causal, window,
                                     cap):
    """The port's wrapper on CPU tensors (its plain version) against the
    reference's plain version and its Pallas kernel in interpret mode."""
    q = RNG.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = RNG.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = RNG.standard_normal((B, Skv, K, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ops.flash_attention(_tt(q), _tt(k), _tt(v), **kw).numpy()
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), bq=16, bkv=16, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-5)


def test_flash_matches_model_attention():
    """The plain version against the reference model's chunked attend."""
    from repro.models.attention import attend
    q = RNG.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = RNG.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = RNG.standard_normal((2, 32, 2, 16)).astype(np.float32)
    got = ops.flash_attention(_tt(q), _tt(k), _tt(v), causal=True).numpy()
    want = attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, chunk=8)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_fully_masked_rows_give_the_mean_of_v():
    """Rows a whole window past the last key see no key: the finite mask
    gives p = 1 for every key, so both packages return the mean of v."""
    B, Sq, Skv, H, hd, window = 1, 40, 16, 2, 8, 8
    q = RNG.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = RNG.standard_normal((B, Skv, H, hd)).astype(np.float32)
    v = RNG.standard_normal((B, Skv, H, hd)).astype(np.float32)
    got = ops.flash_attention(_tt(q), _tt(k), _tt(v), causal=True,
                              window=window).numpy()
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[:, Skv + window:],
                               np.broadcast_to(v.mean(axis=1)[:, None],
                                               got[:, Skv + window:].shape),
                               rtol=1e-5, atol=1e-6)
