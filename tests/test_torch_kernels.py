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
    """A CPU tensor takes the plain version: no launch is counted."""
    before = dict(ops.LAUNCHES)
    ops.dedup_embedding_striped(_tt(np.zeros(4, np.int32), "int32"),
                                torch.zeros(2, 4, 8),
                                _tt(np.zeros((1, 1), np.int32), "int32"))
    ops.dedup_matmul(torch.zeros(3, 4), torch.zeros(1, 4, 8),
                     _tt(np.zeros((1, 1), np.int32), "int32"))
    assert ops.LAUNCHES == before


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
