"""The port's dry-run traced on the mini meshes, each cell in a
subprocess of its own fake world (ports of ``tests/test_dryrun_mini.py``'s
two traced cells, with their ``slow`` marks): a train cell whose
collectives are counted and whose per-device FLOPs make a
``useful_flops_ratio`` between 0.5 and 1.0 (6·N·D against the traced
forward, backward and remat, plus attention), and a multi-pod decode
cell."""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run_cell(tmp, arch, shape, multi=False):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mini", "--out", tmp]
    if multi:
        cmd.append("--multi-pod")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=540)
    assert r.returncode == 0, r.stderr[-2000:]
    mesh = "multi" if multi else "single"
    with open(os.path.join(tmp, f"{arch}__{shape}__{mesh}.json")) as f:
        return json.load(f)


@pytest.mark.slow
def test_train_cell_single_pod(tmp_path):
    rec = _run_cell(str(tmp_path), "deepseek-7b", "train_4k")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["meta"]["mesh"] == "2x2" and rec["meta"]["devices"] == 4
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes accessed"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert rec["collectives"]["total"] > 0          # sharded -> collectives
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert 0.5 < rec["roofline"]["useful_flops_ratio"] < 1.0
    # params + AdamW state + batch, one rank's quarter of it at most
    meta = rec["meta"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] <= \
        meta["param_bytes_global"] + meta["opt_bytes_global"] + \
        2 * 4 * 256 * 4096


@pytest.mark.slow
def test_decode_cell_multi_pod(tmp_path):
    rec = _run_cell(str(tmp_path), "mamba2-1.3b", "decode_32k", multi=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["meta"]["mesh"] == "2x2x2"
