"""Benchmark of the PyTorch / CUDA port (``repro_torch``): inference
queries over deduplicated LM variants served out of SQLite on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.
"""
import importlib.util
from pathlib import Path


def load_module(bench_dir: Path, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py`` as a module (names hold dots and
    dashes, so by path)."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
