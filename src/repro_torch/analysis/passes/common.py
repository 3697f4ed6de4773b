"""Shared AST helpers for the contract lint passes."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

__all__ = ["iter_functions", "call_attr", "call_root", "expr_names"]

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def iter_functions(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every function/method in the
    module, with ``Class.method`` / ``outer.inner`` dotted names."""
    def walk(node: ast.AST, stack: List[str]) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS):
                qual = ".".join(stack + [child.name])
                yield qual, child
                yield from walk(child, stack + [child.name])
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, stack + [child.name])
            else:
                yield from walk(child, stack)
    yield from walk(tree, [])


def call_attr(node: ast.Call) -> Optional[str]:
    """The attribute/function name being called, if syntactically
    evident: ``a.b.c(...)`` -> ``c``, ``f(...)`` -> ``f``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def call_root(node: ast.Call) -> Optional[str]:
    """Leftmost name of a dotted call: ``time.time()`` -> ``time``."""
    f = node.func
    while isinstance(f, ast.Attribute):
        f = f.value
    if isinstance(f, ast.Name):
        return f.id
    return None


def expr_names(node: ast.AST) -> List[str]:
    """Every ``Name`` id and ``Attribute`` attr mentioned under ``node``
    (used for fuzzy 'does this expression touch a slab' tests)."""
    out: List[str] = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out
