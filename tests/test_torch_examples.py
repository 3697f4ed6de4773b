"""The port's examples and scripts beside the reference's, on the CPU.

Each ``examples/torch_*.py`` runs with ``--device cpu`` (kernel and index
mode ``torch``) beside its reference example, and their printed lines
are compared:

* exactly: store pages, reduction, dedup counts and reconstruction
  errors; the serial run's hit ratio and virtual I/O; the traffic run's
  offered / served / shed / goodput / p50 / p99 (virtual clock);
  accuracy; the fine-tune's frozen fractions and pages before / after;
* not compared: the wall-clock lines (compute, end-to-end, batch p50 /
  p99, speedup), the async run's hit ratio and I/O (the prefetch budget
  reads the measured compute clock, ``src/repro/serving/engine.py:659``),
  the database's path, and the lines only the port prints (where each
  batch was served, the kernels' launches).

``torch_train_tiny`` runs 5 steps against ``repro.launch.train.main``
with the same arguments.  The two packages draw their initial weights
from different generators (JAX's PRNG is not reproduced in torch), so
both resume one reference checkpoint written after step 1: losses 1e-5.
``scripts/torch_run_lints.py`` exits 0 on ``src/repro_torch`` and 1 on a
planted finding; ``scripts/torch_trace_report.py`` prints the reference
script's tables for the same traffic run's trace.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.launch.train import main as jtrain_main
from test_obs import _traced_run as jtraced_run
from test_torch_obs import _traced_run
from repro.obs import write_trace as jwrite_trace
from repro_torch.obs import write_trace

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-5


def _env(tmp_path):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", TMPDIR=str(tmp_path))


def _run(cmd, tmp_path):
    out = subprocess.run([sys.executable, *cmd], capture_output=True,
                         text=True, env=_env(tmp_path), cwd=str(ROOT),
                         timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout.splitlines()


def _pair(tmp_path, name, tmp_db=False):
    """(reference lines, port lines) of one example; ``tmp_db`` runs a
    copy of the reference with its database moved out of ``/tmp``."""
    ref = ROOT / "examples" / f"{name}.py"
    if tmp_db:
        copy = tmp_path / f"{name}.py"
        copy.write_text(ref.read_text().replace("sqlite:////tmp/",
                                                f"sqlite:///{tmp_path}/"))
        ref = copy
    want = _run([str(ref)], tmp_path)
    got = _run([str(ROOT / "examples" / f"torch_{name}.py"), "--device",
                "cpu"], tmp_path)
    return want, got


def _without(lines, *prefixes):
    return [ln for ln in lines if not ln.strip().startswith(prefixes)]


def test_quickstart_prints_the_reference_lines(tmp_path):
    want, got = _pair(tmp_path, "quickstart", tmp_db=True)
    skip = ("committed store to", "device:", "[kernels]")
    assert _without(got, *skip) == _without(want, *skip)
    assert any(ln.startswith("pages: ") for ln in got)
    assert any("reconstruction err" in ln for ln in got)
    assert any(ln.startswith("served 3 batches") for ln in got)
    assert "(torch)" in got[-2]
    assert got[-1].startswith("[kernels] launches=")


def test_multi_model_serving_prints_the_reference_lines(tmp_path):
    want, got = _pair(tmp_path, "multi_model_serving")

    def compared(lines):
        """The lines held exactly: the store, the serial run's served /
        hit ratio / virtual I/O, the async run's served line, the traffic
        run and the accuracy."""
        i = next(i for i, ln in enumerate(lines)
                 if ln.startswith("[async"))
        serial = lines[:i]
        rest = lines[i:]
        keep = _without(serial, "compute time", "end-to-end", "p50 / p99",
                        "device")
        keep += [ln for ln in rest
                 if ln.startswith(("[async", "[open-loop", "accuracy"))
                 or ln.strip().startswith(("served", "offered", "goodput",
                                           "request p50"))]
        return keep
    assert compared(got) == compared(want)
    assert any(ln.startswith("accuracy") for ln in got)
    assert any(ln.strip().startswith("request p50/p99") for ln in got)
    assert sum("through its staging tail (torch)" in ln for ln in got) == 2


def test_finetune_dedup_prints_the_reference_lines(tmp_path):
    want, got = _pair(tmp_path, "finetune_dedup")
    assert got[:-1] == want
    assert got[-2].startswith("pages before/after update:")
    assert got[-1].startswith("[kernels] launches=")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_tiny_losses_equal_the_reference(tmp_path, capsys):
    args = ["--arch", "deepseek-7b", "--reduced", "--batch", "8", "--seq",
            "64", "--lr", "3e-3", "--ckpt-every", "50", "--log-every", "20"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jtrain_main(args + ["--steps", "1", "--ckpt", str(ref_dir)])
    shutil.copytree(ref_dir, port_dir)
    want = jtrain_main(args + ["--steps", "5", "--ckpt", str(ref_dir),
                               "--resume", "auto"])
    got = _load_example("torch_train_tiny").main(
        ["--device", "cpu", "--steps", "5", "--ckpt", str(port_dir),
         "--resume", "auto"])
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=LOSS_TOL)
    out = capsys.readouterr().out
    assert "[resume] restored step 1" in out
    assert "over 4 steps" in out


def test_run_lints_port_script(tmp_path):
    script = str(ROOT / "scripts" / "torch_run_lints.py")
    good = subprocess.run([sys.executable, script, "--no-ruff"],
                          capture_output=True, text=True, cwd=str(ROOT))
    assert good.returncode == 0, good.stdout + good.stderr
    assert "0 finding(s)" in good.stdout
    bad = tmp_path / "repro_torch" / "serving" / "planted.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(pool, idx, rows):\n"
                   "    pool.slab.index_copy_(0, idx, rows)\n")
    out = subprocess.run([sys.executable, script, "--no-ruff",
                          str(tmp_path)], capture_output=True, text=True,
                         cwd=str(ROOT))
    assert out.returncode == 1, out.stdout + out.stderr
    assert "slab-write" in out.stdout


def test_trace_report_port_script(tmp_path):
    """The port's script on a port trace prints the reference script's
    tables for the reference's trace of the same run; on the reference's
    trace it prints exactly what the reference script prints; a broken
    identity exits 1."""
    fe, _, tracer = _traced_run()
    jfe, _, jtracer = jtraced_run()
    port = write_trace(str(tmp_path / "port.json"), tracer, clock=fe.clock)
    ref = jwrite_trace(str(tmp_path / "ref.json"), jtracer, clock=jfe.clock)

    def report(script, trace):
        out = subprocess.run([sys.executable,
                              str(ROOT / "scripts" / script), trace],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(ROOT))
        return out.returncode, out.stdout.splitlines()[1:], out.stderr
    rc, got, _ = report("torch_trace_report.py", port)
    jrc, want, _ = report("trace_report.py", ref)
    assert rc == jrc == 0
    assert got == want
    assert any("critical path" in ln for ln in got)
    assert report("torch_trace_report.py", ref)[:2] == (jrc, want)
    doc = json.loads(Path(port).read_text())
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "request" and not ev["args"].get("shed"):
            ev["args"]["queue_s"] += 1e-9
            break
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(doc))
    rc, _, err = report("torch_trace_report.py", str(broken))
    assert rc == 1
    assert "queue_s+service_s != latency_s" in err


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_multi_model_serving",
                                  "torch_finetune_dedup",
                                  "torch_train_tiny"])
def test_examples_need_a_card_unless_told(tmp_path, name):
    """Without ``--device cpu`` an example runs on the card, and without
    one it stops with the port's error instead of moving to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    extra = ["--steps", "1"] if name == "torch_train_tiny" else []
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / f"{name}.py"), *extra],
                         capture_output=True, text=True, timeout=600,
                         env=_env(tmp_path), cwd=str(ROOT))
    assert out.returncode != 0
    assert "RuntimeError" in out.stderr and "CUDA" in out.stderr
