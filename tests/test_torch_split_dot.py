"""``dot``'s split3 route: an fp32 operand against a bf16 one on the card.

The fp32 operand is split exactly into three bf16 parts
(``kernels.ref.split_bf16x3``, the plain version of the CUDA kernel, laid
out ``[x2 | x1 | x0]``) and one bf16 GEMM sums the exact products in
fp32.  Held here on the CPU: the split is exact bit for bit;
``dot_route`` picks the route only for a plain CUDA fp32 activation of
at least ``SPLIT_MIN_ROWS`` rows against a bf16 weight, needing no
gradient (fake CUDA tensors stand in for the card's); the product through
the plain split is as close to the float64 product as SPLIT_ERR_LIMIT
times the fp32 GEMM, and the GEMMs over x0 alone and over x0 + x1 are
not; the CPU model forwards keep their routes, and a forward with the
split forced stays close to them.  The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import build, layers

F32, BF16 = torch.float32, torch.bfloat16
#: the split3 product's relative distance from float64, at most this many
#: times the fp32 GEMM's (chip_smoke's SPLIT_ERR_LIMIT)
SPLIT_ERR_LIMIT = 6.0


def _finite_values(n, seed=0):
    """fp32 values of both signs whose exponents span [-110, 127] (the
    split's exact range), the largest and smallest such, and zeros."""
    g = np.random.default_rng(seed)
    mant = g.uniform(1.0, 2.0, n) * g.choice([-1.0, 1.0], n)
    x = np.ldexp(mant, g.integers(-110, 127, n)).astype(np.float32)
    fmax = np.finfo(np.float32).max
    edge = np.float32([0.0, -0.0, fmax, -fmax, 2.0 ** -110, -2.0 ** -110,
                       1.0, -1.0, 1.0 + 2.0 ** -23, 3.0 ** 20])
    return torch.from_numpy(np.concatenate([x, edge]))


def _parts(s, n):
    """(x0, x1, x2) of a split laid out [x2 | x1 | x0]"""
    return s[:, 2 * n:].float(), s[:, n:2 * n].float(), s[:, :n].float()


@pytest.mark.parametrize("cols", [8, 1])
def test_plain_split_is_exact(cols):
    """x0 + x1 + x2 == x bit for bit (zeros of either sign included), each
    part in bf16 and of x's sign, laid out [R, 3C] smallest first."""
    x = _finite_values(199_990).reshape(-1, cols)
    s = ref.split_bf16x3(x)
    assert s.dtype == BF16 and s.shape == (x.shape[0], 3 * cols)
    p0, p1, p2 = _parts(s, cols)
    total = (p0 + p1) + p2
    assert torch.equal(total.view(torch.int32), x.view(torch.int32))
    for p in (p0, p1, p2):
        assert torch.equal(torch.signbit(p), torch.signbit(x))


def test_plain_split_keeps_inf_and_nan_in_the_first_part():
    """inf and NaN go whole into x0, the other parts are signed zeros (so
    a product propagates them as the fp32 GEMM does); a NaN whose payload
    lies in the cut bits stays a NaN."""
    nan_low = torch.tensor([0x7F800001], dtype=torch.int32).view(F32)
    x = torch.cat([torch.tensor([float("inf"), -float("inf"),
                                 float("nan")]), nan_low]).reshape(1, -1)
    p0, p1, p2 = _parts(ref.split_bf16x3(x), 4)
    assert p0[0, :2].tolist() == [float("inf"), -float("inf")]
    assert bool(torch.isnan(p0[0, 2:]).all())
    for p in (p1, p2):
        assert bool((p == 0).all())
        assert torch.equal(torch.signbit(p), torch.signbit(x))


def test_split_wrapper_runs_the_plain_version_on_the_cpu():
    x = torch.randn(5, 12)
    n0 = ops.LAUNCHES["split_bf16x3"]
    assert torch.equal(ops.split_bf16x3(x), ref.split_bf16x3(x))
    assert ops.LAUNCHES["split_bf16x3"] == n0


# ----------------------------------------------------------- the route --
def _route_cases():
    """(name, a, b, want) on fake CUDA tensors and real CPU ones."""
    cases = []
    rows = layers.SPLIT_MIN_ROWS
    with FakeTensorMode():
        cuda = torch.device("cuda")
        a32 = torch.empty(rows, 32, device=cuda)
        a16 = torch.empty(rows, 32, device=cuda, dtype=BF16)
        w16 = torch.empty(32, 8, device=cuda, dtype=BF16)
        w32 = torch.empty(32, 8, device=cuda)
        cases += [
            ("cuda fp32 x bf16", a32, w16, "split3"),
            ("cuda bf16 x fp32", a16, w32, "fp32"),
            ("cuda 3-D fp32 x bf16", a32.reshape(2, rows // 2, 32), w16,
             "split3"),
            ("cuda fp32 x bf16, one row short", torch.empty(
                rows - 1, 32, device=cuda), w16, "fp32"),
            ("cuda fp32 x bf16, a decode step", torch.empty(
                4, 1, 32, device=cuda), w16, "fp32"),
            ("cuda fp32 x fp32", a32, w32, "fp32"),
            ("cuda bf16 x bf16", a16, w16, "bf16"),
            ("cuda fp32 x batched bf16", a32, w16.expand(2, 32, 8),
             "fp32"),
            ("cuda fp32 x bf16 needing grad", a32,
             w16.clone().requires_grad_(), "fp32"),
            ("cuda fp32 needing grad x bf16", a32.clone().requires_grad_(),
             w16, "fp32"),
        ]
    cpu32 = torch.zeros(rows, 32)
    cpu16 = torch.zeros(32, 8, dtype=BF16)
    cases += [("cpu fp32 x bf16", cpu32, cpu16, "fp32"),
              ("cpu bf16 x bf16", cpu32.to(BF16), cpu16, "bf16")]
    return cases


@pytest.mark.parametrize("case", range(len(_route_cases())))
def test_dot_route(case):
    name, a, b, want = _route_cases()[case]
    assert layers.dot_route(a, b) == want, name


def test_dot_route_keeps_dtensors_off_the_split(monkeypatch):
    """A DTensor operand keeps the fp32 route (``LowPrecisionDot`` in fp32,
    for its backward's all-reduce), on either side."""
    with FakeTensorMode():
        a = torch.empty(layers.SPLIT_MIN_ROWS, 32, device="cuda")
        w = torch.empty(32, 8, device="cuda", dtype=BF16)
        assert layers.dot_route(a, w) == "split3"
        for marked in (a, w):
            monkeypatch.setattr(layers, "is_dtensor",
                                lambda t, m=marked: t is m)
            assert layers.dot_route(a, w) == "fp32"


# --------------------------------------------------------- the product --
def _rel_err(y, exact):
    """||y - exact|| / ||exact|| (Frobenius), ``exact`` in float64."""
    return float((y.double() - exact).norm() / exact.norm())


@pytest.mark.parametrize("M,K,N,scale", [(64, 256, 48, 1.0),
                                         (40, 1600, 24, 1e-3),
                                         (3, 4096, 16, 30.0),
                                         (1, 7, 5, 1e5)])
def test_split_product_within_fp32_summation_error(M, K, N, scale):
    """Through the plain split and the CPU's ``mm.dtype``: every element
    within the fp32 summation bound of 3K terms, 3K * 2**-24 * (|a| @ |b|),
    of the float64 product, and as a whole as close to it as
    SPLIT_ERR_LIMIT times ``torch.matmul`` in fp32; the same GEMM over x0
    alone or over x0 + x1 is not (a split that lost a part, or a weight
    stacked with zeros, fails here)."""
    g = torch.Generator().manual_seed(M * K + N)
    a = torch.randn(2, M, K, generator=g) * scale
    b = (torch.randn(K, N, generator=g) * 0.02).to(BF16)
    got = layers.split3_dot(a, b)
    assert got.shape == (2, M, N)
    assert got.dtype == F32
    exact = a.double() @ b.double()
    bound = 3 * K * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - exact).abs() <= bound).all())
    limit = SPLIT_ERR_LIMIT * _rel_err(torch.matmul(a, b.float()), exact)
    assert _rel_err(got, exact) <= limit
    s = ref.split_bf16x3(a.reshape(-1, K))              # [x2 | x1 | x0]
    x0 = torch.mm(s[:, 2 * K:], b, out_dtype=F32)
    x01 = torch.mm(s[:, K:], torch.cat([b, b]), out_dtype=F32)
    for control in (x0, x01):
        assert _rel_err(control.reshape(2, M, N), exact) > limit


# ----------------------------------------------------- the CPU models --
def _served(arch):
    """(api, bf16 params as served, tokens) of a reduced arch."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    api = build(cfg)
    lm = convert.lm_tensors(api.init(0), dtype="bfloat16")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(1, cfg.vocab, (2, 24))
        .astype(np.int32))
    return api, lm.rebuild(lm.tensors), tokens


def _spy(monkeypatch, force_split=False):
    """Record every dot's (dtypes, route); with ``force_split`` the mixed
    fp32 x bf16 products take split3 on the CPU too."""
    seen = []
    real = layers.dot_route

    def route(a, b):
        r = real(a, b)
        mixed = a.dtype == F32 and b.dtype == BF16 and b.dim() == 2
        if force_split and mixed and r == "fp32":
            r = "split3"
        seen.append(((a.dtype, b.dtype), r))
        return r
    monkeypatch.setattr(layers, "dot_route", route)
    return seen


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b"])
def test_cpu_forwards_keep_their_routes(arch, monkeypatch):
    """The dense and hybrid prefills on the CPU: every product takes the
    route it took before the split existed (fp32 where the operands
    promote to fp32, else bf16), the attention output's fp32 x bf16
    projection among them."""
    api, params, tokens = _served(arch)
    seen = _spy(monkeypatch)
    with torch.no_grad():
        api.prefill(params, {"tokens": tokens})
    assert seen
    for (da, db), r in seen:
        assert r == ("fp32" if torch.promote_types(da, db) == F32
                     else "bf16")
    n_layers = api.cfg.num_layers
    assert sum(dt == (F32, BF16) for dt, _ in seen) >= n_layers


@pytest.mark.parametrize("arch", ["deepseek-7b", "hymba-1.5b"])
def test_forced_split_prefill_matches_the_fp32_route(arch, monkeypatch):
    """The same prefill with the split route forced on the CPU (one split
    a layer, the wo projection): the logits stay within 5e-3 of the fp32
    route's (equal here; the two sums differ only in their last bits,
    which a bf16 rounding of a layer's output can carry one bf16 step)."""
    api, params, tokens = _served(arch)
    with torch.no_grad():
        want, _ = api.prefill(params, {"tokens": tokens})
    seen = _spy(monkeypatch, force_split=True)
    with torch.no_grad():
        got, _ = api.prefill(params, {"tokens": tokens})
    assert sum(r == "split3" for _, r in seen) == api.cfg.num_layers
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=5e-3)
