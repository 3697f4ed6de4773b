"""span-discipline: traces must nest and charged work must be spanned.

The obs tracer's conservation invariant — per-channel span time equals
``VirtualClock.spent`` *exactly* — only holds when (a) every span is
opened and closed through the context manager, so exception paths can
never leave a span dangling, and (b) the code paths that put virtual
seconds on a clock channel do so inside an open span, so the trace
actually attributes the time the clock booked.  Two rules:

* **Rule A** — ``span_begin``/``span_end`` are the tracer's low-level
  plumbing; calling them anywhere outside ``obs/trace.py`` bypasses
  the context manager's exception safety and is flagged unconditionally
  (no pragma).
* **Rule B** — a ``serving/`` function that both fetches pages (the
  ChannelChargePass FETCH tokens) *and* charges a channel (its CHARGE
  tokens) must have every charge call lexically inside a ``with``
  statement whose items include a ``span(...)`` call.  Helpers whose
  caller owns the span carry ``# repro: allow-unspanned`` on the
  ``def`` line documenting that.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Finding, LintPass, Source
from .channel_charge import CHARGE_TOKENS, FETCH_TOKENS
from .common import call_attr, iter_functions

__all__ = ["SpanDisciplinePass"]

# the only module allowed to touch the low-level span plumbing
_TRACER_MODULE = "obs/trace.py"
_RAW_SPAN_CALLS = {"span_begin", "span_end"}


def _spanned_node_ids(fn: ast.AST) -> set:
    """ids of every AST node lexically inside a ``with`` block whose
    items include a ``span(...)`` call (the tracer context manager)."""
    out: set = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.With):
            continue
        if not any(isinstance(it.context_expr, ast.Call)
                   and call_attr(it.context_expr) == "span"
                   for it in node.items):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                out.add(id(sub))
    return out


class SpanDisciplinePass(LintPass):
    """Context-manager-only spans; charged fetch paths must be spanned."""
    name = "span-discipline"
    pragma = "allow-unspanned"
    description = ("raw span_begin/span_end outside the tracer, or "
                   "charged fetch paths in serving/ outside a span")

    def __init__(self, path_fragment: str = "repro/",
                 charged_fragment: str = "serving/"):
        self.path_fragment = path_fragment
        self.charged_fragment = charged_fragment

    def run(self, src: Source) -> List[Finding]:
        if self.path_fragment not in src.path:
            return []
        out: List[Finding] = []
        # Rule A: the raw begin/end API never leaves the tracer module.
        # Unsuppressable by design: bypass the pragma-aware finding()
        # and build the Finding directly.
        if not src.path.endswith(_TRACER_MODULE):
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Call) \
                        and call_attr(node) in _RAW_SPAN_CALLS:
                    out.append(Finding(
                        src.path, node.lineno, node.col_offset, self.name,
                        f"raw {call_attr(node)}() call outside the tracer "
                        "module; open spans with the `with tracer.span("
                        "...)` context manager so exception paths close "
                        "them"))
        # Rule B: fetch+charge functions keep their charges inside spans
        if self.charged_fragment in src.path:
            out.extend(self._check_charged(src))
        return [f for f in out if f is not None]

    def _check_charged(self, src: Source) -> List[Finding]:
        out: List[Finding] = []
        for qual, fn in iter_functions(src.tree):
            fetches = False
            charges: List[ast.Call] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = call_attr(node)
                if attr in FETCH_TOKENS:
                    fetches = True
                if attr in CHARGE_TOKENS:
                    charges.append(node)
            if not (fetches and charges):
                continue
            spanned = _spanned_node_ids(fn)
            loose = [c for c in charges if id(c) not in spanned]
            if loose:
                # report at the def line so one pragma covers the helper
                out.append(self.finding(
                    src, fn,
                    f"{qual} fetches pages and charges a channel ("
                    + ", ".join(sorted({call_attr(c) for c in loose}))
                    + ") outside any `with ...span(...)` block; the "
                    "trace cannot attribute that time — wrap the "
                    "charge in a span or mark `# repro: "
                    "allow-unspanned` if the caller owns the span"))
        return out
