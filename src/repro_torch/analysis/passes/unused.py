"""unused: unused/shadowed bindings and dead code.

Four cheap-but-real hygiene checks:

* unused module-level imports (skipped in ``__init__.py`` re-export
  modules; names listed in ``__all__`` or re-exported via the
  ``import x as x`` idiom count as used),
* function locals assigned once and never read (``_``-prefixed names
  are the deliberate-discard idiom and are skipped),
* parameters/assignments that shadow load-bearing builtins
  (``# repro: allow-shadow`` when deliberate),
* statements unreachable after ``return``/``raise``/``break``/
  ``continue``.

Suppress with ``# repro: allow-unused`` / ``# repro: allow-shadow`` on
the line (or the line above).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from ..lint import Finding, LintPass, Source
from .common import iter_functions

__all__ = ["UnusedBindingPass"]

SHADOW_BUILTINS = {
    "id", "list", "dict", "set", "tuple", "type", "input", "filter",
    "map", "sum", "min", "max", "vars", "next", "iter", "hash", "len",
    "str", "int", "float", "bytes", "all", "any", "open", "eval",
    "format", "sorted", "zip", "range", "object", "dir", "abs",
    "round", "pow", "print", "bool",
}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_TERMINAL = (ast.Return, ast.Raise, ast.Break, ast.Continue)


def _loaded_names(tree: ast.AST) -> set:
    out = {n.id for n in ast.walk(tree)
           if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    # `x += ...` reads x even though the target's ctx is Store (and when
    # x is a numpy view, the "store" IS the read-modify-write the caller
    # wants) — AugAssign names count as used
    out |= {n.target.id for n in ast.walk(tree)
            if isinstance(n, ast.AugAssign)
            and isinstance(n.target, ast.Name)}
    return out


class UnusedBindingPass(LintPass):
    """Unused imports/locals, builtin shadowing, dead code."""
    name = "unused"
    pragma = "allow-unused"
    description = "unused imports/locals, shadowed builtins, dead code"

    def _mk(self, src: Source, node: ast.AST, message: str,
            token: str) -> Optional[Finding]:
        line = getattr(node, "lineno", 1)
        if src.allowed(line, token):
            return None
        return Finding(src.path, line, getattr(node, "col_offset", 0),
                       self.name, message)

    # -- unused module-level imports -----------------------------------------
    def _check_imports(self, src: Source) -> List[Optional[Finding]]:
        if src.path.endswith("__init__.py"):
            return []
        used = _loaded_names(src.tree)
        used |= {n.attr for n in ast.walk(src.tree)
                 if isinstance(n, ast.Attribute)}
        exported = set()
        for node in src.tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets) \
                    and isinstance(node.value, (ast.List, ast.Tuple)):
                exported |= {e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)}
        out: List[Optional[Finding]] = []
        for node in src.tree.body:
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            if isinstance(node, ast.ImportFrom) \
                    and node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                if a.asname == a.name and a.asname is not None:
                    continue                     # `import x as x` re-export
                bound = a.asname or a.name.split(".")[0]
                if bound in used or bound in exported:
                    continue
                out.append(self._mk(
                    src, node, f"import `{bound}` is never used",
                    "allow-unused"))
        return out

    # -- unused locals -------------------------------------------------------
    def _check_locals(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []
        for qual, fn in iter_functions(src.tree):
            loads = _loaded_names(fn)
            declared = set()
            for node in ast.walk(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    declared |= set(node.names)
            assigns = {}
            for node in ast.walk(fn):
                if isinstance(node, _FUNCS) and node is not fn:
                    continue
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    assigns.setdefault(name, []).append(node)
            for name, nodes in assigns.items():
                if name.startswith("_") or name in loads \
                        or name in declared or len(nodes) > 1:
                    continue
                out.append(self._mk(
                    src, nodes[0],
                    f"local `{name}` in {qual} is assigned but never read",
                    "allow-unused"))
        return out

    # -- shadowed builtins ---------------------------------------------------
    def _check_shadows(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []
        for qual, fn in iter_functions(src.tree):
            a = fn.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                if p.arg in SHADOW_BUILTINS:
                    out.append(self._mk(
                        src, p,
                        f"parameter `{p.arg}` of {qual} shadows a builtin",
                        "allow-shadow"))
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in SHADOW_BUILTINS:
                        out.append(self._mk(
                            src, node,
                            f"assignment to `{t.id}` shadows a builtin",
                            "allow-shadow"))
        return out

    # -- dead code -----------------------------------------------------------
    def _check_dead(self, src: Source) -> List[Optional[Finding]]:
        out: List[Optional[Finding]] = []
        for node in ast.walk(src.tree):
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not isinstance(block, list):
                    continue
                for i, stmt in enumerate(block[:-1]):
                    if isinstance(stmt, _TERMINAL):
                        out.append(self._mk(
                            src, block[i + 1],
                            "unreachable statement after "
                            f"`{type(stmt).__name__.lower()}`",
                            "allow-unused"))
                        break
        return out

    def run(self, src: Source) -> List[Finding]:
        out = (self._check_imports(src) + self._check_locals(src)
               + self._check_shadows(src) + self._check_dead(src))
        return [f for f in out if f is not None]
