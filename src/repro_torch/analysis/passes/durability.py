"""durability: every durable mutation in the storage layer sits at a
registered crash seam.

Counterpart of ``repro.analysis.passes.durability``, whose default
scope (a directory and a module) the suffix-only ``files`` argument
cannot express: here that scope is the port's.

The crash-point sweep (``storage/crashpoints.py``) proves recovery by
SIGKILLing the process at every registered seam — but only at
*registered* ones.  A new ``os.replace`` / ``os.rename`` (an atomic
file commit) or a sqlite ``.commit()`` added without a
``crash_point(...)`` call nearby is a durable state transition the
sweep can never kill at: the exhaustiveness guarantee silently decays.

One rule over the configured storage files (default: everything under
``repro_torch/storage/`` plus ``repro_torch/core/store.py``): a function that
issues a durable commit —

  * ``os.replace(...)`` or ``os.rename(...)`` (Rule A), or
  * ``<self|con|cur>...commit()`` (Rule B, the sqlite spelling)

— must also call ``crash_point(...)`` somewhere in its *own* body
(nested defs own their own seams).  ``# repro: allow-unjournaled`` on
the flagged line (or the comment line above) documents a deliberate
exception, e.g. schema DDL on a brand-new database where there is no
earlier state to recover to.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from ..lint import Finding, LintPass, Source
from .common import call_attr, call_root

__all__ = ["DurabilityPass"]

#: Rule B receivers: a ``.commit()`` on anything rooted at one of these
#: is a database transaction commit, not e.g. a VCS wrapper
_COMMIT_ROOTS = {"self", "con", "cur"}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _own_calls(fn: ast.AST) -> List[ast.Call]:
    """Every Call in ``fn``'s own body, excluding nested def/class
    bodies — a nested helper owns its own crash seams."""
    out: List[ast.Call] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _DEFS):
                continue
            if isinstance(child, ast.Call):
                out.append(child)
            walk(child)

    walk(fn)
    return out


def _iter_defs(tree: ast.Module):
    """(qualname, node) for every function/method, like
    ``common.iter_functions`` but NOT descending into nested defs'
    bodies twice is fine — we just need each def once."""
    def walk(node: ast.AST, stack: List[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name])
                yield qual, child
                yield from walk(child, stack + [child.name])
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, stack + [child.name])
            else:
                yield from walk(child, stack)
    yield from walk(tree, [])


class DurabilityPass(LintPass):
    """Durable commits in the storage layer must sit at a registered
    crash point, or the kill-at-every-seam sweep stops being
    exhaustive."""
    name = "durability"
    pragma = "allow-unjournaled"
    description = ("storage-layer os.replace/os.rename/db-commit calls "
                   "outside any crash_point seam")

    def __init__(self, files: Optional[Sequence[str]] = None):
        #: explicit suffix scoping (fixtures/tests); None = the default
        #: storage-layer scope rule in :meth:`_in_scope`
        self.files = tuple(files) if files is not None else None

    def _in_scope(self, src: Source) -> bool:
        if self.files is not None:
            return src.endswith(*self.files)
        return ("repro_torch/storage/" in src.path
                or src.path.endswith("repro_torch/core/store.py"))

    def run(self, src: Source) -> List[Finding]:
        if not self._in_scope(src):
            return []
        out: List[Finding] = []
        for qual, fn in _iter_defs(src.tree):
            calls = _own_calls(fn)
            journaled = any(call_attr(c) == "crash_point" for c in calls)
            if journaled:
                continue
            for c in calls:
                attr, root = call_attr(c), call_root(c)
                if root == "os" and attr in ("replace", "rename"):
                    what = f"os.{attr}"
                elif attr == "commit" and root in _COMMIT_ROOTS:
                    what = f"{root}...commit()"
                else:
                    continue
                out.append(self.finding(
                    src, c,
                    f"{qual} issues a durable commit ({what}) with no "
                    "crash_point(...) in the same function — the "
                    "kill-at-every-seam sweep cannot reach this "
                    "transition; register a seam (crashpoints.py) or "
                    "mark `# repro: allow-unjournaled` with a rationale"))
        return [f for f in out if f is not None]
