"""The harness end to end on the CPU at a tiny size: discovery by name of a
cell added as files alone, the store built once and then opened, the
result line, the check failing under a program at fault, and the
card-only path."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiny import ROOT, make_root, run_tiny
from portbench import store

E2E = {"rows_per_s", "query_p95_ms", "setup_s"}
LAYER = {"switch_ms", "compute_ms", "prefill_mfu", "device_idle_pct",
         "engine_host_ms", "switch_access_ms", "switch_assemble_ms",
         "switch_rebuild_ms", "setup_fault_s", "setup_sqlite_s",
         "split_bf16x3_launches"}


@pytest.mark.parametrize("cell", ["tiny-d", "tiny-h", "tiny-m"])
def test_a_cell_added_as_files_runs_and_is_correct(tiny_root, cell):
    r = run_tiny(tiny_root, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == E2E
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "check"
    assert r["check"]["widest_gap"]["value"] <= \
        r["check"]["widest_gap"]["limit"]
    json.dumps(r)


def test_a_generate_cell_added_as_data_alone(tiny_root):
    """The variant alternating every query, three greedy steps a row: a
    mix of other shapes and another check span, as a data file alone;
    the check reads each served token at its own position."""
    r = run_tiny(tiny_root, "tiny-d-alt")
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == E2E


def test_traced_run_reports_the_per_layer_metrics(tiny_root):
    # the variant alternates every query: the window holds switches
    r = run_tiny(tiny_root, "tiny-d-alt", trace=True, seconds=1.0)
    # no device on the CPU: the trace's readers find nothing to read
    assert set(r["metrics"]) == LAYER - {"device_idle_pct"} \
        or set(r["metrics"]) == LAYER
    assert "flash_attention_roofline" not in r["metrics"]
    assert r["device"]["window_s"] > 0
    phases = {k for k, _ in r["breakdown"]["idle_gaps"]}
    assert {"compute", "switch"} <= phases
    assert r["metrics"]["switch_ms"]["value"] > 0


def test_store_built_once_then_opened(tmp_path):
    root = make_root(tmp_path)
    first = run_tiny(root, "tiny-d")
    again = run_tiny(root, "tiny-d", seed=6)
    assert first["store"]["built"] and not again["store"]["built"]
    cache = root / "portbench" / ".cache"
    assert [p.name for p in cache.iterdir()
            if p.name.startswith("tiny-dense")] == [
        "tiny-dense-" + store.digest(root, json.loads(
            (root / "portbench/configs/tiny-dense.json").read_text()))]
    # a changed configuration builds anew; a cut build's leftover goes
    cfg = root / "portbench" / "configs" / "tiny-dense.json"
    c = json.loads(cfg.read_text())
    c["store"]["store_seed"] = 9
    cfg.write_text(json.dumps(c))
    (cache / "tiny-dense-0123456789abcdef.building").mkdir()
    third = run_tiny(root, "tiny-d")
    assert third["store"]["built"] and third["correct"]
    assert len([p for p in cache.iterdir()
                if p.name.startswith("tiny-dense")]) == 1


def test_a_traced_run_of_a_new_architecture_counts_its_operations(
        tiny_root):
    """The toy MoE, traced: its prefill operations come from its own
    module; no device, so nothing reads a kernel's roofline."""
    r = run_tiny(tiny_root, "tiny-m", trace=True, seconds=1.0)
    assert r["correct"] is True
    assert 0 < r["metrics"]["prefill_mfu"]["value"] < 105
    assert "flash_attention_roofline" not in r["metrics"]


def altered_token(engine_cls, monkeypatch):
    compute = engine_cls._compute

    def bad(self, model, prompts, steps):
        toks, dt = compute(self, model, prompts, steps)
        toks = toks.copy()
        toks[0, 0] = (toks[0, 0] + 1) % 256          # the tiny vocabulary
        return toks, dt
    monkeypatch.setattr(engine_cls, "_compute", bad)


def half_the_rows(engine_cls, monkeypatch):
    compute = engine_cls._compute

    def bad(self, model, prompts, steps):
        half = (len(prompts) + 1) // 2
        toks, dt = compute(self, model, prompts[:half], steps)
        return np.concatenate([toks, toks])[:len(prompts)], dt
    monkeypatch.setattr(engine_cls, "_compute", bad)


def shifted_logits(engine_cls, monkeypatch):
    """An error in the logits under the margin of the best token: the
    served tokens stay right, the logits do not."""
    compute = engine_cls._compute

    def bad(self, model, prompts, steps):
        out = compute(self, model, prompts, steps)
        self.last_logits = self.last_logits + 0.05 * torch.randn_like(
            self.last_logits)
        return out
    monkeypatch.setattr(engine_cls, "_compute", bad)


@pytest.mark.parametrize("fault", [altered_token, half_the_rows,
                                   shifted_logits])
@pytest.mark.parametrize("cell", ["tiny-d", "tiny-h", "tiny-m"])
def test_a_program_at_fault_is_not_correct(tiny_root, monkeypatch, fault,
                                           cell):
    from repro_torch.serving.engine import LMServingEngine
    fault(LMServingEngine, monkeypatch)
    r = run_tiny(tiny_root, cell)
    assert r["correct"] is False
    failed = [k for k, v in r["check"].items() if not v["value"] <= v["limit"]]
    assert failed
    if fault is shifted_logits:
        assert failed == ["widest_logit_err"]


def run_py(root, *extra, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "ds7b-2v-score", "--seed", "1", "--seconds", "1",
                           *extra], cwd=root, capture_output=True, text=True,
                          env=env, timeout=300)


def test_run_without_a_card_prints_no_result():
    out = run_py(ROOT, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_with_only_the_benchmarks_files_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda_device, tiny_root):
    """On the card: the tiny cells through the CUDA kernels, correct."""
    r = run_tiny(tiny_root, "tiny-h", seed=3, seconds=1.0,
                 device=cuda_device)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert torch.cuda.max_memory_allocated() > 0


@pytest.mark.cuda
def test_a_new_architecture_traced_on_the_card(cuda_device, tiny_root):
    """On the card: the toy MoE through ``flash_attention``, correct, its
    step's share of the peak and the kernel's share of its roofline
    read from its own module's counts, each within (0, 105] %."""
    r = run_tiny(tiny_root, "tiny-m", seed=4, seconds=2.0, trace=True,
                 device=cuda_device)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    for m in ("prefill_mfu", "flash_attention_roofline"):
        assert 0 < r["metrics"][m]["value"] <= 105
    tied = r["check"]["tied_share"]
    assert 0 < tied["value"] <= tied["limit"]
    # the program's spans and counters reach the readers on the card
    for m in ("engine_host_ms", "switch_access_ms", "setup_fault_s"):
        assert r["metrics"][m]["value"] > 0
    assert "split_bf16x3_launches" in r["metrics"]


@pytest.mark.cuda
def test_ties_on_the_card(cuda_device, tiny_root):
    """On the card: the toy MoE's rows that route as the float32
    reference does pass the limits on each seed, where over every row
    the widest error may not; the float8 control fails them."""
    from portbench import archs, control
    limits = archs.read_config(tiny_root / "portbench", "tiny-moe")["check"]
    recs = control.readings(tiny_root, "tiny-m", [31, 32, 33, 34, 35, 36],
                            30.0, device=cuda_device, log=print)
    for r in recs:
        assert r["failed"] == 0 and r["rows"] > 0
        assert 0 < r["tied_share"] <= limits["tied_limit"]
        assert r["program_logit_err"] <= limits["logit_limit"]
        assert r["program_gap"] <= limits["gap_limit"]
        assert r["control_logit_err"] > limits["logit_limit"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 3 * 2 ** 40])
def test_the_check_sample_is_drawn_before_the_window(seed):
    """From the seed alone: the same indices each time, within the mix's
    check span, with both variants in them."""
    from portbench import check
    from portbench.traffic import Traffic
    spec = json.loads((ROOT / "portbench/traffic/score-16x1024.json")
                      .read_text())
    t = Traffic(spec, ["v0", "v1"], 20480, seed)
    picked = check.plan(t, seed)
    assert picked == check.plan(Traffic(spec, ["v0", "v1"], 20480, seed),
                                seed)
    assert len(picked) == spec["check_queries"]
    assert all(0 <= i < spec["check_within"] for i in picked)
    assert {t.variant(i) for i in picked} == {"v0", "v1"}
