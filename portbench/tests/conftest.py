"""Fixtures of the benchmark's CPU tests.

    PYTHONPATH=src python -m pytest -q portbench/tests

``tiny_root`` is a checkout in a temporary directory: this ``portbench``
copied whole, the program's ``src`` linked, the tiny configurations and
throwaway traffic mixes of ``tests/data`` added as new files, and a
``BENCHMARK.json`` that adds cells for them to the repository's.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny-d": ("tiny-dense", "tiny-score"),
              "tiny-h": ("tiny-hybrid", "tiny-score"),
              "tiny-d-alt": ("tiny-dense", "tiny-alternate")}


def make_root(dest: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (dest / "src").symlink_to(ROOT / "src")
    for cfg, mix in TINY_CELLS.values():
        shutil.copy(DATA / f"{cfg}.json", dest / "portbench" / "configs")
        shutil.copy(DATA / f"{mix}.json", dest / "portbench" / "traffic")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (cfg, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "a CPU test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def run_tiny(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             trace: bool = False):
    import time
    from portbench import harness
    return harness.run_cell(root, cell, seed, seconds, trace,
                            time.perf_counter(), device=torch.device("cpu"),
                            kernel_mode="torch", index_mode="torch",
                            log=lambda m: None)
