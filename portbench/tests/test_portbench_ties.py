"""The check's tie rule on the CPU at a tiny size: rows whose expert
choice the float32 reference itself cannot make leave the widest
numbers (``check.tie_rule``, ``Reference.select``), the dense and hybrid
cells are judged as before, and the toy MoE passes where it routes as
the reference does and fails where it is at fault."""
import numpy as np
import pytest
import torch

from tiny import run_tiny
from portbench import archs, check, control

#: the check's numbers of the parent harness (commit c0f7bc8), which had
#: no tie rule, at these cells and seeds
PARENT = {
    ("tiny-d", 5): dict(correct=True, widest_gap=0.0,
                        widest_logit_err=0.0029863975942134857, failed=0),
    ("tiny-d", 2 ** 31 + 7): dict(correct=True, widest_gap=0.0,
                                  widest_logit_err=0.0027650948613882065,
                                  failed=0),
    ("tiny-h", 5): dict(correct=True, widest_gap=9.083747863769531e-05,
                        widest_logit_err=0.007421314716339111, failed=0),
    ("tiny-h", 2 ** 31 + 7): dict(correct=True,
                                  widest_gap=0.001857846975326538,
                                  widest_logit_err=0.005604930222034454,
                                  failed=0),
}
#: the seeds the toy's limits were set from (tiny-moe.json)
SEEDS = list(range(1, 17))
CPU = dict(device=torch.device("cpu"), kernel_mode="torch",
           index_mode="torch")
#: a window long enough to finish every sampled query on a loaded host
SECONDS = 3.0


def numbers(r):
    return {"correct": r["correct"],
            **{k: v["value"] for k, v in r["check"].items()}}


@pytest.mark.parametrize("cell,seed", sorted(PARENT))
def test_dense_and_hybrid_are_judged_as_before(tiny_root, cell, seed):
    r = run_tiny(tiny_root, cell, seed=seed, seconds=SECONDS)
    assert numbers(r) == dict(PARENT[(cell, seed)], tied_share=0.0)
    assert r["check"]["tied_share"]["limit"] == 0.0


@pytest.fixture(scope="module")
def toy(tiny_root):
    """(check limits, control.readings over SEEDS) of the toy MoE."""
    cfg = archs.read_config(tiny_root / "portbench", "tiny-moe")
    recs = control.readings(tiny_root, "tiny-m", SEEDS, 30.0,
                            log=lambda m: None, **CPU)
    return cfg["check"], {r["seed"]: r for r in recs}


@pytest.mark.parametrize("seed", SEEDS)
def test_the_toy_program_passes(tiny_root, toy, seed):
    limits, recs = toy
    r = run_tiny(tiny_root, "tiny-m", seed=seed, seconds=SECONDS)
    assert r["correct"] is True
    n = numbers(r)
    assert 0 < n["tied_share"] <= limits["tied_limit"] <= check.TIED_CAP
    # the run judges what control.readings read for the program
    assert n["widest_logit_err"] == recs[seed]["program_logit_err"]
    assert n["tied_share"] == recs[seed]["tied_share"]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_fails_the_logits(toy, seed):
    limits, recs = toy
    assert recs[seed]["control_logit_err"] > limits["logit_limit"]


def test_ties_are_what_flips_the_toys_rows(toy):
    """Over every row the program's widest error reaches the control's
    on some seeds (a row whose expert choice flipped); over the untied
    rows it stays under the limit on all of them."""
    limits, recs = toy
    every = [r["all_rows_program_logit_err"] for r in recs.values()]
    assert max(every) > limits["logit_limit"]
    assert max(r["program_logit_err"] for r in recs.values()) \
        <= limits["logit_limit"]


#: tiny-moe's expert layers: 3 layers, the first dense
EXPERT_LAYERS = 2


def expert_layer():
    """A counter of the program's expert-layer calls: each forward runs
    the toy's expert layers in order, so the call number modulo their
    count names the layer."""
    state = {"n": 0}

    def which():
        i = state["n"] % EXPERT_LAYERS
        state["n"] += 1
        return i
    return which


def fp8(x, dim):
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def router_off(layer, monkeypatch):
    """One expert layer's router weight off by a tenth of its spread."""
    import repro_torch.models.moe as moe
    route, which = moe.route, expert_layer()

    def bad(xt, p, m, *a, **k):
        if which() == layer:
            r = p["router"]
            g = torch.Generator(device=r.device).manual_seed(0)
            noise = torch.randn(r.shape, generator=g, device=r.device)
            p = dict(p, router=r + 0.1 * r.float().std() * noise.to(r.dtype))
        return route(xt, p, m, *a, **k)
    monkeypatch.setattr(moe, "route", bad)


def fp8_layer(layer, monkeypatch):
    """One expert layer's products with their operands in float8 e4m3."""
    import repro_torch.models.moe as moe
    experts, edot, which = moe.moe_experts, moe._edot, expert_layer()
    on = {"now": False}

    def bad_experts(*a, **k):
        on["now"] = which() == layer
        try:
            return experts(*a, **k)
        finally:
            on["now"] = False

    def bad_edot(a, b):
        if on["now"]:
            a, b = fp8(a.float(), -1), fp8(b.float(), -2)
        return edot(a, b)
    monkeypatch.setattr(moe, "moe_experts", bad_experts)
    monkeypatch.setattr(moe, "_edot", bad_edot)


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("fault", [router_off, fp8_layer])
def test_an_expert_layer_at_fault_is_not_correct(tiny_root, monkeypatch,
                                                 fault, layer, seed):
    fault(layer, monkeypatch)
    r = run_tiny(tiny_root, "tiny-m", seed=seed, seconds=SECONDS)
    assert r["correct"] is False
    c = r["check"]
    assert c["widest_logit_err"]["value"] > c["widest_logit_err"]["limit"]
    assert c["tied_share"]["value"] <= c["tied_share"]["limit"]


def test_the_tie_set_is_the_references_alone(tiny_root, monkeypatch):
    """The program's logits replaced by noise move no row in or out of
    the tie set."""
    from repro_torch.serving.engine import LMServingEngine
    seen, readings = [], check.readings

    def spy(*a, **k):
        r = readings(*a, **k)
        seen.append(r["fp32"]["margin"])
        return r
    monkeypatch.setattr(check, "readings", spy)
    clean = run_tiny(tiny_root, "tiny-m", seed=3, seconds=SECONDS)
    compute = LMServingEngine._compute

    def noise(self, model, prompts, steps):
        out = compute(self, model, prompts, steps)
        self.last_logits = torch.randn_like(self.last_logits)
        return out
    monkeypatch.setattr(LMServingEngine, "_compute", noise)
    noisy = run_tiny(tiny_root, "tiny-m", seed=3, seconds=SECONDS)
    assert clean["correct"] and not noisy["correct"]
    assert len(seen) == 2 and np.array_equal(seen[0], seen[1])
    assert (seen[0] < 0.01).any() and (seen[0] >= 0.01).any()
    assert numbers(clean)["tied_share"] == numbers(noisy)["tied_share"] > 0


def judged(margin, gap, err, tie_margin):
    r = {"margin": np.asarray(margin), "gap": np.asarray(gap)[:, None],
         "logit_err": np.asarray(err)}
    return check.widest(r, tie_margin)


def test_widest_leaves_out_the_tied_rows_only():
    inf = float("inf")
    assert judged([inf, inf], [0.1, 0.2], [0.3, 0.4], 0.0) == \
        (0.2, 0.4, 0.0)
    assert judged([0.001, 0.5], [0.9, 0.2], [0.9, 0.4], 0.01) == \
        (0.2, 0.4, 0.5)
    # a sample of tied rows alone fails
    assert judged([0.001, 0.002], [0.0, 0.0], [0.0, 0.0], 0.01) == \
        (inf, inf, 1.0)


@pytest.mark.parametrize("check_cfg,ok", [
    ({}, True), ({"tie_margin": 0.01, "tied_limit": 0.5}, True),
    ({"tie_margin": 0.01, "tied_limit": 0.6}, False),
    ({"tie_margin": -1.0}, False)])
def test_the_tie_rule_keeps_half_the_rows_judged(check_cfg, ok):
    cfg = {"name": "x", "check": dict(gap_limit=1, logit_limit=1,
                                      **check_cfg)}
    if ok:
        margin, limit = check.tie_rule(cfg)
        assert margin == check_cfg.get("tie_margin", 0.0)
        assert limit == check_cfg.get("tied_limit", 0.0) <= check.TIED_CAP
    else:
        with pytest.raises(ValueError):
            check.tie_rule(cfg)
