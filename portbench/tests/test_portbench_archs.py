"""One module an architecture (``portbench/archs``).

The parity tests hold what the modules give against numbers recorded
from the harness before the architectures had modules of their own, when
the generic files branched on ``"architecture"``: the layouts, the
program's configurations and the counts at both real configurations, and
the tiny configurations' drawn weights and reference logits bit for bit.
The toy architecture of ``data/archs`` goes into a checkout as files
alone and is served through the program."""
import ast
import hashlib
import json

import pytest
import torch

from tiny import DATA, ROOT, make_root
from portbench import archs, harness, weights
from portbench.counts import flash_attention as fa
from portbench.counts import prefill
from portbench.reference import Reference, flat_weights

OUT_DS, OUT_HY = 0.005773502691896258, 0.0035355339059327372

SPECS = {
    "deepseek-7b-2v": [
        ("blocks/ln1/scale", (6, 4096), "normal", 0.1),
        ("blocks/attn/wq", (6, 4096, 4096), "normal", 0.02),
        ("blocks/attn/wk", (6, 4096, 4096), "normal", 0.02),
        ("blocks/attn/wv", (6, 4096, 4096), "normal", 0.02),
        ("blocks/attn/wo", (6, 4096, 4096), "normal", OUT_DS),
        ("blocks/ln2/scale", (6, 4096), "normal", 0.1),
        ("blocks/mlp/w1", (6, 4096, 11008), "normal", 0.02),
        ("blocks/mlp/w3", (6, 4096, 11008), "normal", 0.02),
        ("blocks/mlp/w2", (6, 11008, 4096), "normal", OUT_DS),
        ("embed", (20480, 4096), "normal", 0.02),
        ("final_norm/scale", (4096,), "normal", 0.1),
        ("head", (4096, 20480), "normal", 0.02),
    ],
    "hymba-1.5b-2v": [
        ("blocks/ln1/scale", (16, 1600), "normal", 0.1),
        ("blocks/attn/wq", (16, 1600, 1600), "normal", 0.02),
        ("blocks/attn/wk", (16, 1600, 320), "normal", 0.02),
        ("blocks/attn/wv", (16, 1600, 320), "normal", 0.02),
        ("blocks/attn/wo", (16, 1600, 1600), "normal", OUT_HY),
        ("blocks/mamba/in_proj", (16, 1600, 6482), "normal", 0.02),
        ("blocks/mamba/out_proj", (16, 3200, 1600), "normal", OUT_HY),
        ("blocks/mamba/conv_w", (16, 4, 3232), "normal", 0.02),
        ("blocks/mamba/conv_b", (16, 3232), "normal", 0.02),
        ("blocks/mamba/dt_bias", (16, 50), "dt_bias", 0.0),
        ("blocks/mamba/A_log", (16, 50), "a_log", 0.0),
        ("blocks/mamba/Dp", (16, 50), "one_plus", 0.1),
        ("blocks/mamba/ssm_norm", (16, 3200), "normal", 0.1),
        ("blocks/ln2/scale", (16, 1600), "normal", 0.1),
        ("blocks/mlp/w1", (16, 1600, 5504), "normal", 0.02),
        ("blocks/mlp/w3", (16, 1600, 5504), "normal", 0.02),
        ("blocks/mlp/w2", (16, 5504, 1600), "normal", OUT_HY),
        ("embed", (32001, 1600), "normal", 0.02),
        ("final_norm/scale", (1600,), "normal", 0.1),
        ("head", (1600, 32001), "normal", 0.02),
    ],
}

#: the ModelConfig fields that differ from their defaults
PROGRAM = {
    "deepseek-7b-2v": dict(name="deepseek-7b-2v", family="dense",
                           num_layers=6, d_model=4096, num_heads=32,
                           kv_heads=32, d_ff=11008, vocab=20480,
                           head_dim=128),
    "hymba-1.5b-2v": dict(name="hymba-1.5b-2v", family="hybrid",
                          num_layers=16, d_model=1600, num_heads=25,
                          kv_heads=5, d_ff=5504, vocab=32001, head_dim=64,
                          sliding_window=1024, window_pattern=-3,
                          ssm=dict(d_state=16, d_conv=4, expand=2,
                                   head_dim=64, n_groups=1, chunk=256),
                          hybrid=True),
}

#: (rows, tokens) -> (prefill operations, [(operations, bytes)] a layer)
COUNTS = {
    "deepseek-7b-2v": {
        (16, 1024): (40616700411904.0,
                     [(137573171200.0, 536870912.0)] * 6),
        (8, 2048): (41439991955456.0,
                    [(275012124672.0, 536870912.0)] * 6),
    },
    "hymba-1.5b-2v": {
        (16, 1024): (26116281124864.0,
                     [(53739520000.0, 125829120.0)] * 16),
        (8, 2048): (26625148478464.0,
                    [(107426611200.0, 125829120.0)]
                    + [(80556851200.0, 125829120.0)] * 7
                    + [(107426611200.0, 125829120.0)]
                    + [(80556851200.0, 125829120.0)] * 6
                    + [(107426611200.0, 125829120.0)]),
    },
}

#: sha256 of each variant's drawn leaves, and of the reference's logits
#: (6 rows of 24 tokens, blocks of 4, the last 2 positions)
TINY = {
    "tiny-dense": {
        "v0": "9c8c3744281e577aeef595e7091105e0ee4244782ac8b3cf5748ffe3f50e680b",
        "v1": "ee0ed26b5945ba65c67a17a08f45f4106e925d3e9ad6e5505e09672b54225658",
        "v0-fp32": "d503fd51d40510ba2de11e45f38ba0713689fe07c8567c8e2304fe1065a5b405",
        "v1-fp32": "9d199d498845ac3d7aa6907f36982333a3f6b23df29e5563a56de7a21407a3bf",
        "v0-fp8": "74f1f6fe3ded573c56ef3896d70652e58fe3a4e670b0e76ca928ebb5e5ce6f6a",
        "v1-fp8": "4ad38691dcd42431a7c3d54c97260b11cd947d777ec1683e650630ee417939a3",
    },
    "tiny-hybrid": {
        "v0": "7c24f962d35564f9d68d910a185e5b9227377e7971c29f464b4582b4be0fa7b8",
        "v1": "df9e8c2e8c493d5d511be35c807f35d464faa1c1b442e3d7b18cc808024a18a7",
        "v0-fp32": "1fbb58d98d4bd01047a959f2f4eb9d29a70979320dfc5f9a224998855b25865c",
        "v1-fp32": "9f3d15fd29e531677cca8d8aa652aa47e0a24a077990ba56dc137e696673e929",
        "v0-fp8": "1a7dda9ed2b331818452879e7e1a3efc945676b2d3bf0e1a79c54b7cea46f93a",
        "v1-fp8": "058886a5fc3af4fb175be56ca4cfc1086366fe7baab793ff445fb6e70db4a7a5",
    },
}


def real(name):
    return archs.read_config(ROOT / "portbench", name)


def tiny(name):
    return json.loads((DATA / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_real_leaf_specs_are_the_parents(name):
    got = [("/".join(p), tuple(s), i, sc)
           for p, s, i, sc in weights.leaf_specs(real(name))]
    assert got == SPECS[name]


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_real_program_configs_are_the_parents(name):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    want = dict(PROGRAM[name])
    if "ssm" in want:
        want["ssm"] = SSMConfig(**want["ssm"])
    assert harness.model_config(real(name)) == ModelConfig(**want)


@pytest.mark.parametrize("shape", [(16, 1024), (8, 2048)])
@pytest.mark.parametrize("name", sorted(COUNTS))
def test_real_counts_are_the_parents(name, shape):
    flops, calls = COUNTS[name][shape]
    cfg = real(name)
    assert prefill.flops(cfg, *shape) == flops
    assert fa.calls(cfg, *shape) == calls


def digest(tree):
    h = hashlib.sha256()
    for p in sorted(tree):
        t = tree[p]
        h.update("/".join(p).encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_draws_and_reference_logits_are_the_parents(name):
    cfg = tiny(name)
    drawn = weights.variant_weights(cfg, "cpu")
    toks = torch.randint(1, cfg["vocab_size"], (6, 24),
                         generator=torch.Generator().manual_seed(0))
    got = {v: digest(t) for v, t in drawn.items()}
    for prec in ("fp32", "fp8"):
        for v in drawn:
            lg = Reference(cfg, flat_weights(drawn[v]), prec).last_logits(
                toks, 4, 2)
            got[f"{v}-{prec}"] = hashlib.sha256(lg.numpy().tobytes()
                                                ).hexdigest()
    assert got == TINY[name]


def branches_on_architecture(path):
    """Comparisons of ``<x>["architecture"]`` with anything."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                if isinstance(side, ast.Subscript) \
                        and isinstance(side.slice, ast.Constant) \
                        and side.slice.value == "architecture":
                    yield node.lineno


def test_no_generic_file_branches_on_an_architecture():
    files = [f for f in (ROOT / "portbench").rglob("*.py")
             if "archs" not in f.relative_to(ROOT / "portbench").parts]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), n) for f in files
           for n in branches_on_architecture(f)]
    assert bad == []


def test_a_new_architecture_goes_in_as_files_alone(tmp_path):
    """The tiny checkout adds files and changes none of portbench's."""
    root = make_root(tmp_path)
    theirs = {p.relative_to(root / "portbench"): p.read_bytes()
              for p in (root / "portbench").rglob("*") if p.is_file()}
    ours = {p.relative_to(ROOT / "portbench"): p.read_bytes()
            for p in (ROOT / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}
    assert all(theirs[p] == b for p, b in ours.items())
    added = {str(p) for p in set(theirs) - set(ours)}
    assert "archs/toy-moe.py" in added and "configs/tiny-moe.json" in added
    assert all(p.startswith(("archs/", "configs/", "traffic/"))
               for p in added)


def test_an_unknown_architecture_is_named(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "archs").mkdir()
    (tmp_path / "configs" / "x.json").write_text(json.dumps(
        {"architecture": "no-such"}))
    with pytest.raises(ValueError, match="no-such"):
        archs.read_config(tmp_path, "x")


def test_toy_reference_is_the_programs_float32_forward(tiny_root):
    """The toy's plain reference and the program's own float32 forward
    of its MoE family agree over the same weights."""
    import dataclasses
    from repro_torch.convert import lm_tensors
    from repro_torch.models import build
    cfg = archs.read_config(tiny_root / "portbench", "tiny-moe")
    drawn = weights.variant_weights(cfg, "cpu")["v1"]
    assert drawn[("blocks", "moe", "router")].dtype == torch.float32
    t = torch.randint(1, cfg["vocab_size"], (3, 24),
                      generator=torch.Generator().manual_seed(2))
    want = Reference(cfg, flat_weights(drawn)).last_logits(t, block=3)
    lm = lm_tensors(weights.nested({p: v.float().numpy()
                                    for p, v in drawn.items()}),
                    dtype="float32", per_layer=True)
    mc = dataclasses.replace(harness.model_config(cfg), dtype="float32")
    got, _ = build(mc, attention="plain").prefill(
        lm.rebuild(lm.tensors), {"tokens": t}, t.shape[1] + 1)
    torch.testing.assert_close(got[:, 0].float(), want[:, 0], rtol=1e-4,
                               atol=1e-4)


def test_toy_variant_redraws_its_experts(tiny_root):
    cfg = archs.read_config(tiny_root / "portbench", "tiny-moe")
    a = weights.variant_weights(cfg, "cpu")
    for leaf in ("router", "ew1", "ew3", "ew2"):
        p = ("blocks", "moe", leaf)
        assert torch.equal(a["v1"][p][0], a["v0"][p][0])
        assert not torch.equal(a["v1"][p][1], a["v0"][p][1])
    r = a["v0"][("blocks", "moe", "router")]
    assert float(r.abs().max()) <= 1 / 8          # U(-1, 1) / sqrt(64)
    assert a["v1"][("dense_blocks", "mlp", "w1")] is \
        a["v0"][("dense_blocks", "mlp", "w1")]
