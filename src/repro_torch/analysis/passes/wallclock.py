"""wallclock: no raw ``time.time()`` in the repro tree.

The serving layer's timings are *virtual* (``StorageModel`` /
``FetchComputeTimeline``); where real elapsed time is genuinely wanted
(benchmark harness walls), ``time.perf_counter()`` is the monotonic
choice — ``time.time()`` jumps under NTP and silently corrupts measured
bandwidths.  Sites that truly need wall-clock epoch time carry
``# repro: allow-wallclock``.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Finding, LintPass, Source

__all__ = ["WallClockPass"]


class WallClockPass(LintPass):
    """Flags raw time.time() anywhere in the scanned tree."""
    name = "wallclock"
    pragma = "allow-wallclock"
    description = "raw time.time() where the virtual clock or perf_counter belongs"

    def run(self, src: Source) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "time"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "time"):
                out.append(self.finding(
                    src, node,
                    "time.time() — use time.perf_counter() for measured "
                    "durations or the virtual clock (StorageModel / "
                    "FetchComputeTimeline) for charged time"))
        return [f for f in out if f is not None]
