"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level name (the port's ``repro_torch`` begins with ``repro``),
and ``run.py``'s check of ``sys.modules`` compares the same way."""
import ast
import sys

import pytest

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_module_under_portbench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), n) for f in files for n in top_names(f)
           if n in FORBIDDEN]
    assert bad == []
    used = {n for f in files for n in top_names(f)}
    assert "repro_torch" in used            # compared whole, it passes


@pytest.mark.parametrize("name,flagged", [
    ("repro.core", True), ("jax", True), ("jaxlib.xla", True),
    ("flax.linen", True), ("repro_torch.db", False),
    ("reprox", False), ("jax_helpers", False)])
def test_the_run_flags_loaded_modules_by_whole_top_name(monkeypatch, name,
                                                        flagged):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "portbench"))
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(run.leaked_modules()) is flagged
