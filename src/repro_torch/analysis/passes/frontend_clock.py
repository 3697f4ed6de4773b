"""frontend-clock: the request-level serving tier lives on the virtual
clock — no free latency, no wall time.

The frontend's p50/p99/goodput numbers are *virtual-clock* quantities:
a traffic/frontend code path that measures wall time (even the
otherwise-tolerated ``time.perf_counter()``) would mix nondeterministic
runner noise into a latency distribution the bench guard treats as
deterministic, and a path that dispatches work (``.run(...)`` /
``.generate(...)``) without charging the clock (``advance`` /
``tick_to`` / ``charge_fetch``) serves requests in zero simulated time
— free latency, the exact lie the SLO accounting exists to prevent.

Two rules over the configured frontend files (default:
``serving/frontend.py`` + ``serving/traffic.py``):

  * **no wall time** — any ``time.*()`` call is flagged (the frontend
    has no measured-duration escape hatch; the engines keep theirs).
  * **dispatch charges the clock** — a function that calls ``.run(`` or
    ``.generate(`` must also call ``advance``/``tick_to``/
    ``charge_fetch`` somewhere in its body.

``# repro: allow-untimed`` on the ``def`` line documents a helper whose
caller owns the charge.
"""
from __future__ import annotations

import ast
from typing import List, Sequence

from ..lint import Finding, LintPass, Source
from .common import call_attr, call_root, iter_functions

__all__ = ["FrontendClockPass"]

#: calls that consume simulated service time
DISPATCH_TOKENS = {"run", "generate"}
#: calls that put seconds on the virtual clock
CLOCK_TOKENS = {"advance", "tick_to", "charge_fetch"}

_DEFAULT_FILES = ("serving/frontend.py", "serving/traffic.py")


class FrontendClockPass(LintPass):
    """Pins the traffic/frontend modules to the virtual clock."""
    name = "frontend-clock"
    pragma = "allow-untimed"
    description = ("frontend/traffic paths that consume time without "
                   "charging the virtual clock")

    def __init__(self, files: Sequence[str] = _DEFAULT_FILES):
        self.files = tuple(files)

    def run(self, src: Source) -> List[Finding]:
        if not src.endswith(*self.files):
            return []
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call) and call_root(node) == "time":
                out.append(self.finding(
                    src, node,
                    f"time.{call_attr(node)}() in a frontend module — "
                    "request-level serving is strictly virtual-clock "
                    "(VirtualClock.advance/tick_to); wall time here "
                    "corrupts the deterministic latency distribution"))
        for qual, fn in iter_functions(src.tree):
            dispatches, charges = [], False
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = call_attr(node)
                if attr in DISPATCH_TOKENS \
                        and isinstance(node.func, ast.Attribute):
                    dispatches.append(node)
                if attr in CLOCK_TOKENS:
                    charges = True
            if dispatches and not charges:
                out.append(self.finding(
                    src, fn,
                    f"{qual} dispatches work ("
                    + ", ".join(sorted({call_attr(n) for n in dispatches}))
                    + ") but never charges the virtual clock "
                    "(advance/tick_to/charge_fetch) — free latency; "
                    "charge the clock or mark `# repro: allow-untimed` "
                    "if the caller owns the charge"))
        return [f for f in out if f is not None]
