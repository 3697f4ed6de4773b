"""The tiny checkout the benchmark's CPU tests run in.

``make_root(dest)`` is a checkout in ``dest``: this ``portbench`` copied
whole, the program's ``src`` linked, the tiny configurations, throwaway
traffic mixes and architecture modules of ``data/`` added as new files,
and a ``BENCHMARK.json`` that adds cells for them to the repository's.
(A module of its own, not ``conftest``: the repository's ``tests`` has a
``conftest`` too.)
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny-d": ("tiny-dense", "tiny-score"),
              "tiny-h": ("tiny-hybrid", "tiny-score"),
              "tiny-m": ("tiny-moe", "tiny-score"),
              "tiny-d-alt": ("tiny-dense", "tiny-alternate")}


def make_root(dest: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (dest / "src").symlink_to(ROOT / "src")
    for cfg, mix in TINY_CELLS.values():
        shutil.copy(DATA / f"{cfg}.json", dest / "portbench" / "configs")
        shutil.copy(DATA / f"{mix}.json", dest / "portbench" / "traffic")
    for arch in (DATA / "archs").glob("*.py"):
        shutil.copy(arch, dest / "portbench" / "archs")
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


def run_tiny(root: Path, cell: str, seed: int = 5, seconds: float = 0.5,
             trace: bool = False, device=None):
    """One run of ``cell`` in the program's ``torch`` modes, on the CPU
    unless ``device`` is given."""
    from portbench import harness
    device = device or torch.device("cpu")
    modes = {} if device.type == "cuda" else dict(kernel_mode="torch",
                                                  index_mode="torch")
    return harness.run_cell(root, cell, seed, seconds, trace,
                            time.perf_counter(), device=device,
                            log=lambda m: None, **modes)
