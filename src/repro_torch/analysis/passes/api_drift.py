"""api-drift: public-API docstring/signature drift checks.

Three checks:

* ``__all__`` consistency (every scanned file): each exported name must
  actually be defined at module top level, and must appear only once.
* docstring presence (API-surface modules only): public top-level
  classes/functions must carry a docstring — the serving/storage layers
  ARE the repo's API, and an undocumented entry point is where protocol
  contracts silently drift.
* kwarg drift (API-surface modules): a docstring that names a keyword
  as ``arg=`` must refer to a parameter the signature still has —
  the classic drift is renaming a parameter and leaving the docstring
  advertising the old spelling.

``# repro: allow-drift`` on the ``def``/``class`` line suppresses the
docstring checks for that object.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Sequence

from ..lint import Finding, LintPass, Source

__all__ = ["ApiDriftPass", "DEFAULT_API_SURFACE"]

# modules whose public surface must stay documented and drift-free
DEFAULT_API_SURFACE = (
    "repro/serving/", "repro/storage/", "repro/analysis/",
    "repro/core/store.py", "repro/core/bufferpool.py", "repro/db.py",
)

# ``name=value`` (no space: ``seconds = seek + b/bw`` is an equation,
# not a kwarg reference), and not ``name==`` comparisons
_KWARG_RE = re.compile(r"``([a-z_][A-Za-z0-9_]*)=(?!=)")
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _top_level_names(tree: ast.Module) -> set:
    names = set()
    for node in tree.body:
        if isinstance(node, _FUNCS + (ast.ClassDef,)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.Import):
            for a in node.names:
                names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                names.add(a.asname or a.name)
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if isinstance(sub, _FUNCS + (ast.ClassDef,)):
                    names.add(sub.name)
                elif isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
    return names


def _params(fn) -> set:
    a = fn.args
    out = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)
    return out


def _has_kwargs(fn) -> bool:
    return fn.args.kwarg is not None


class ApiDriftPass(LintPass):
    """__all__ consistency, docstring presence, kwarg drift."""
    name = "api-drift"
    pragma = "allow-drift"
    description = "__all__ consistency + public docstring/signature drift"

    def __init__(self, surface: Sequence[str] = DEFAULT_API_SURFACE):
        self.surface = tuple(surface)

    def _in_surface(self, src: Source) -> bool:
        return any(s in src.path if s.endswith("/") else src.path.endswith(s)
                   for s in self.surface)

    def _check_all(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []
        for node in src.tree.body:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "__all__"
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                continue
            exported = [e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)]
            defined = _top_level_names(src.tree)
            # PEP 562: a module __getattr__ serves lazy exports, so
            # absence from the static top level proves nothing
            lazy = any(isinstance(n, _FUNCS) and n.name == "__getattr__"
                       for n in src.tree.body)
            for name in exported:
                if name not in defined and not lazy:
                    out.append(self.finding(
                        src, node,
                        f"__all__ exports `{name}` which is not defined "
                        "at module top level"))
            for name in sorted({n for n in exported
                                if exported.count(n) > 1}):
                out.append(self.finding(
                    src, node, f"__all__ lists `{name}` more than once"))
        return out

    def _check_doc(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []
        for node in src.tree.body:
            if isinstance(node, _FUNCS + (ast.ClassDef,)) \
                    and not node.name.startswith("_") \
                    and ast.get_docstring(node) is None:
                out.append(self.finding(
                    src, node,
                    f"public {type(node).__name__.replace('Def', '').lower()}"
                    f" `{node.name}` has no docstring (API-surface module)"))
        return out

    def _check_kwargs(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []

        def check(node, doc: Optional[str], params: set, has_kw: bool):
            if not doc or has_kw:
                return
            for m in _KWARG_RE.finditer(doc):
                if m.group(1) not in params:
                    out.append(self.finding(
                        src, node,
                        f"docstring of `{node.name}` references kwarg "
                        f"``{m.group(1)}=`` which is not a parameter "
                        "(signature drift?)"))

        for node in ast.walk(src.tree):
            if isinstance(node, _FUNCS):
                check(node, ast.get_docstring(node), _params(node),
                      _has_kwargs(node))
            elif isinstance(node, ast.ClassDef):
                init = next((n for n in node.body
                             if isinstance(n, _FUNCS)
                             and n.name == "__init__"), None)
                if init is not None:
                    check(node, ast.get_docstring(node), _params(init),
                          _has_kwargs(init))
        return out

    def run(self, src: Source) -> List[Finding]:
        out = self._check_all(src)
        if self._in_surface(src):
            out.extend(self._check_doc(src))
            out.extend(self._check_kwargs(src))
        return [f for f in out if f is not None]
