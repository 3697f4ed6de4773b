"""silent-except: no bare ``except:`` and no silently swallowed
exceptions in the repro tree.

The recovery layer (storage/faults.py, DESIGN.md §8) depends on a
typed taxonomy: transient errors retry, corruption quarantines, fatal
errors propagate.  A bare ``except:`` (which also catches
KeyboardInterrupt/SystemExit) or an ``except Exception: pass`` handler
erases that distinction — a corrupt page or an exhausted retry budget
silently becomes "fine", and the serving result is garbage with no
counter incremented anywhere.

Flagged:
  * ``except:`` with no exception type, anywhere;
  * any handler whose body does nothing (only ``pass`` / ``...``) while
    catching ``Exception`` / ``BaseException`` — swallowing the broad
    classes whole.

A narrow typed handler with an empty body (e.g. ``except KeyError:
pass`` probing a dict) is deliberate control flow and stays legal.
Sites that genuinely need a broad silent catch carry
``# repro: allow-silent-except`` with a rationale.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Finding, LintPass, Source

__all__ = ["SilentExceptPass"]

_BROAD = ("Exception", "BaseException")


def _names(node) -> List[str]:
    """Exception class names named by an ``except`` clause type."""
    if node is None:
        return []
    if isinstance(node, ast.Tuple):
        return [n for e in node.elts for n in _names(e)]
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    return []


def _body_is_silent(body) -> bool:
    """True when the handler does nothing at all: only ``pass`` or a
    bare ``...`` expression."""
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, ast.Constant) \
                and stmt.value.value is Ellipsis:
            continue
        return False
    return True


class SilentExceptPass(LintPass):
    """Flags bare ``except:`` and broad-catch handlers that swallow the
    exception without doing anything."""
    name = "silent-except"
    pragma = "allow-silent-except"
    description = ("bare except: or except Exception with a do-nothing "
                   "body — erases the fault taxonomy")

    def run(self, src: Source) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(self.finding(
                    src, node,
                    "bare except: catches KeyboardInterrupt/SystemExit "
                    "too — name the exception types (see the "
                    "storage/faults.py taxonomy)"))
                continue
            names = _names(node.type)
            if any(n in _BROAD for n in names) \
                    and _body_is_silent(node.body):
                out.append(self.finding(
                    src, node,
                    f"except {'/'.join(names)} with a do-nothing body "
                    "silently swallows every failure — handle, re-raise, "
                    "or narrow the type"))
        return [f for f in out if f is not None]
