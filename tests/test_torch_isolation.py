"""The port stands alone: it imports neither jax nor the JAX package, and
its copies of the JAX package's framework-free modules cannot drift.

The copies (obs, storage, core with compress and finetune, configs, the
scheduler, prefetcher, traffic generator, paged KV cache, request
frontend and shard router) must equal their originals once ``repro.``/``repro/`` is renamed to
``repro_torch.``/``repro_torch/`` in import lines and ``-m`` strings;
``data/pipeline.py`` is the one copy allowed to be trimmed (it drops the
jax-only ``make_batch_from_specs``).
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIES = [
    "obs/__init__.py", "obs/trace.py", "obs/metrics.py", "obs/export.py",
    "storage/__init__.py", "storage/backend.py", "storage/crashpoints.py",
    "storage/faults.py", "storage/journal.py", "storage/localdir.py",
    "storage/sqlite.py", "storage/objsim.py",
    "core/__init__.py", "core/blocks.py", "core/lsh.py", "core/magnitude.py",
    "core/dedup.py", "core/pagepack.py", "core/bufferpool.py",
    "core/store.py", "core/compress.py", "core/finetune.py",
    "serving/scheduler.py", "serving/prefetch.py", "serving/traffic.py",
    "serving/kvcache.py", "serving/frontend.py", "serving/router.py",
    "configs/__init__.py", "configs/base.py", "configs/arctic_480b.py",
    "configs/deepseek_7b.py", "configs/gemma2_9b.py", "configs/hymba_1_5b.py",
    "configs/kimi_k2_1t_a32b.py", "configs/mamba2_1_3b.py",
    "configs/phi3_vision_4_2b.py", "configs/qwen2_72b.py",
    "configs/qwen3_14b.py", "configs/whisper_small.py",
]

_RENAME = re.compile(r'(\bimport |\bfrom |"-m", ")repro([./])')


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _bad_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if _forbidden(name):
                yield f"{path.relative_to(ROOT)}:{node.lineno}: {name}"


def test_port_and_smoke_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = [b for f in files for b in _bad_imports(f)]
    assert bad == []
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.db, repro_torch.convert, repro_torch.kernels, "
            "repro_torch.serving.frontend, "
            "repro_torch.serving.shard_pool, repro_torch.launch.mesh, "
            "repro_torch.models, repro_torch.configs; "
            "leaked = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(leaked); sys.exit(1 if leaked else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("rel", COPIES)
def test_copies_match_their_originals(rel):
    original = (SRC / "repro" / rel).read_text()
    expected = _RENAME.sub(r"\1repro_torch\2", original)
    assert (PORT / rel).read_text() == expected


def test_trimmed_pipeline_keeps_the_rest_verbatim():
    """data/pipeline.py: only the jax import and make_batch_from_specs
    go; everything else is the original's text."""
    original = (SRC / "repro" / "data" / "pipeline.py").read_text()
    port = (PORT / "data" / "pipeline.py").read_text()
    start = original.index("def make_batch_from_specs")
    end = original.index("@dataclasses.dataclass")
    trimmed = (original[:start] + original[end:]).replace(
        "import jax\n", "")
    assert port == trimmed
    assert "jax" not in port
