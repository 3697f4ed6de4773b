"""The float32 reference: against itself under reorderings, its scan
against the plain recurrence, and against the program's own float32
forward at a tiny size (the equations agree)."""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tiny import DATA
from portbench import weights
from portbench.reference import Reference, flat_weights, no_tf32


def tiny(name):
    return json.loads((DATA / f"{name}.json").read_text())


def ref_for(name, precision="fp32"):
    cfg = tiny(name)
    w = flat_weights(weights.variant_weights(cfg, "cpu")["v0"])
    return cfg, Reference(cfg, w, precision)


def tokens(cfg, n=6, S=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, cfg["vocab_size"], (n, S), generator=g)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-hybrid"])
def test_rows_permuted_and_blocked_alike(name):
    cfg, ref = ref_for(name)
    t = tokens(cfg)
    full = ref.last_logits(t, block=6)
    perm = torch.randperm(6, generator=torch.Generator().manual_seed(1))
    again = ref.last_logits(t[perm], block=4)
    torch.testing.assert_close(again, full[perm], rtol=1e-5, atol=1e-5)


def test_last_positions_are_the_prefixes_logits():
    cfg, ref = ref_for("tiny-hybrid")
    t = tokens(cfg, n=2)
    three = ref.last_logits(t, block=2, n_last=3)
    for j in range(3):
        short = ref.last_logits(t[:, :t.shape[1] - 2 + j], block=2)
        torch.testing.assert_close(three[:, j], short[:, 0], rtol=1e-5,
                                   atol=1e-5)


def scan(x, dt, A, Bm, Cm, D):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t; y_t = C_t h_t + D x_t."""
    Bsz, S, nh, p = x.shape
    r = nh // Bm.shape[2]
    Bh, Ch = (m.repeat_interleave(r, dim=2) for m in (Bm, Cm))
    h = torch.zeros(Bsz, nh, p, Bm.shape[-1])
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append((h * Ch[:, t, :, None, :]).sum(-1) + D[:, None] * x[:, t])
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("tile", [1, 5, 256])
def test_quadratic_scan_is_the_recurrence(tile):
    g = torch.Generator().manual_seed(3)
    B, S, nh, p, G, N = 2, 19, 4, 3, 2, 5
    x = torch.randn(B, S, nh, p, generator=g)
    dt = F.softplus(torch.randn(B, S, nh, generator=g))
    A = -torch.rand(nh, generator=g) - 0.1
    Bm = torch.randn(B, S, G, N, generator=g)
    Cm = torch.randn(B, S, G, N, generator=g)
    D = torch.randn(nh, generator=g)
    _, ref = ref_for("tiny-hybrid")
    torch.testing.assert_close(ref.ssd(x, dt, A, Bm, Cm, D, tile=tile),
                               scan(x, dt, A, Bm, Cm, D), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-hybrid"])
def test_reference_is_the_programs_float32_forward(name):
    """The program's float32 forward (plain attention, no kernel) over the
    same weights gives the reference's logits: the equations agree."""
    from repro_torch.convert import lm_tensors
    from repro_torch.models import build
    import dataclasses
    from portbench import harness
    cfg = tiny(name)
    drawn = weights.variant_weights(cfg, "cpu")["v1"]
    t = tokens(cfg, n=3)
    want = Reference(cfg, flat_weights(drawn)).last_logits(t, block=3)
    lm = lm_tensors(weights.nested({p: v.float().numpy()
                                    for p, v in drawn.items()}),
                    dtype="float32", per_layer=True)
    mc = dataclasses.replace(harness.model_config(cfg), dtype="float32")
    params = lm.rebuild(lm.tensors)
    got, _ = build(mc, attention="plain").prefill(params, {"tokens": t},
                                                  t.shape[1] + 1)
    torch.testing.assert_close(got[:, 0].float(), want[:, 0], rtol=1e-4,
                               atol=1e-4)


def test_fp8_control_departs_and_tf32_is_restored():
    cfg, ref = ref_for("tiny-dense")
    _, low = ref_for("tiny-dense", "fp8")
    t = tokens(cfg)
    a, b = ref.last_logits(t, 6), low.last_logits(t, 6)
    assert float((a - b).abs().max()) > 1e-3
    before = torch.backends.cuda.matmul.allow_tf32
    with no_tf32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_weights_are_served_rounded_and_variants_share():
    cfg = tiny("tiny-dense")
    a = weights.variant_weights(cfg, "cpu")
    b = weights.variant_weights(cfg, "cpu")
    for path, t in a["v0"].items():
        assert t.dtype == weights.served_dtype(path)
        assert torch.equal(t, b["v0"][path])
    w1 = ("blocks", "mlp", "w1")
    assert torch.equal(a["v1"][w1][0], a["v0"][w1][0])
    assert not torch.equal(a["v1"][w1][1], a["v0"][w1][1])
    assert a["v1"][("embed",)] is a["v0"][("embed",)]
    assert np.isfinite(a["v0"][("blocks", "ln1", "scale")].numpy()).all()


def selecting(B=2, S=5):
    """A reference whose forward is over ``B`` rows (as ``last_logits``
    sets it up), for ``select`` alone."""
    cfg, ref = ref_for("tiny-dense")
    ref._n_last, ref._margins = 1, []
    ref._block = torch.full((B,), float("inf"))
    return ref


def test_select_puts_the_lower_index_first_among_equal_scores():
    ref = selecting(B=1, S=1)
    scores = torch.tensor([[[0.2, 0.5, 0.2, 0.5, 0.1]]])
    assert ref.select(scores, 3).tolist() == [[[1, 3, 0]]]
    # the margin between the 3rd and 4th is 0: a tie
    assert ref._block.tolist() == [0.0]


def test_select_keeps_each_rows_least_margin_at_the_last_positions():
    ref = selecting(B=2)
    s = torch.tensor([[0.6, 0.3, 0.1], [0.5, 0.45, 0.05]])
    scores = torch.stack([s[0].expand(5, 3), s[1].expand(5, 3)]).clone()
    scores[0, 0] = torch.tensor([0.4, 0.4, 0.2])   # not a compared position
    ref.select(scores, 1)
    torch.testing.assert_close(ref._block, torch.tensor([0.3, 0.05]))
    ref.select(scores[:, :, [1, 0, 2]], 2)         # a second routed layer
    torch.testing.assert_close(ref._block, torch.tensor([0.2, 0.05]))
    # every expert chosen: no (k+1)-th, no margin
    ref.select(scores, 3)
    torch.testing.assert_close(ref._block, torch.tensor([0.2, 0.05]))
    with pytest.raises(ValueError):
        ref.select(scores[:1], 1)                  # not the block's rows


def test_margins_are_inf_where_nothing_routes():
    cfg, ref = ref_for("tiny-dense")
    ref.last_logits(tokens(cfg, n=5), block=2)
    assert ref.margins.shape == (5,) and torch.isinf(ref.margins).all()


def test_margins_cover_every_block_and_position_compared():
    """The toy routes through ``select``: its margins, a row's least over
    its routed layers, are the same whichever way the rows are blocked,
    and over more compared positions they can only shrink."""
    from tiny import DATA
    from portbench import archs, load_module
    cfg = archs.Config(tiny("tiny-moe"))
    cfg.arch = load_module(DATA, "archs", "toy-moe")
    w = flat_weights(weights.variant_weights(cfg, "cpu")["v0"])
    ref = Reference(cfg, w)
    t = tokens(cfg, n=6)
    ref.last_logits(t, block=6)
    whole = ref.margins.clone()
    ref.last_logits(t, block=4)
    torch.testing.assert_close(ref.margins, whole, rtol=0, atol=0)
    assert torch.isfinite(whole).all() and (whole >= 0).all()
    ref.last_logits(t, block=6, n_last=4)
    assert (ref.margins <= whole).all() and (ref.margins < whole).any()
