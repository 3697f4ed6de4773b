"""channel-charge: every fetch path must charge a virtual-clock channel.

Counterpart of ``repro.analysis.passes.channel_charge``, keyed to the
port's ``serving/``, whose page moves charge the fitted channel through
``TransferEngine.stop_timer`` (``stats.record`` on the host clock, or
the CUDA events' time settled later): it is a charge here.

The serving results are *time* numbers: a code path that faults pages
from the storage backend (``fault_pages``/``get_pages``/``page_stack``/
``page_array``) without charging a named channel (``fetch_seconds``/
``fetch_group_seconds``/``transfer_seconds``/``_charge_hbm``/
``record``/``record_single``/``_borrow`` or by delegating to the
charged ``access_pages*`` wrappers) makes the clock lie — bytes moved
for free.  The pass checks each function in ``serving/`` for the
pairing; helpers whose *caller* owns the charge carry
``# repro: allow-uncharged`` on the ``def`` line documenting that.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Finding, LintPass, Source
from .common import call_attr, iter_functions

__all__ = ["ChannelChargePass"]

# calls that move bytes from the storage tier
FETCH_TOKENS = {"fault_pages", "get_pages", "page_stack", "page_array",
                "materialize", "materialize_rows"}
# calls that put virtual seconds on a channel (or delegate to one that does)
CHARGE_TOKENS = {"fetch_seconds", "fetch_group_seconds", "transfer_seconds",
                 "charge_fetch", "_charge_hbm", "record", "record_single",
                 "_borrow", "access_pages", "access_pages_grouped", "step",
                 "stop_timer"}


class ChannelChargePass(LintPass):
    """Pairs storage-fetch calls with virtual-clock charges."""
    name = "channel-charge"
    pragma = "allow-uncharged"
    description = "storage fetches in serving/ that never charge a channel"

    def __init__(self, path_fragment: str = "repro_torch/serving/"):
        self.path_fragment = path_fragment

    def run(self, src: Source) -> List[Finding]:
        if self.path_fragment not in src.path:
            return []
        out: List[Finding] = []
        for qual, fn in iter_functions(src.tree):
            fetches, charges = [], False
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = call_attr(node)
                if attr in FETCH_TOKENS:
                    fetches.append(node)
                if attr in CHARGE_TOKENS:
                    charges = True
            if fetches and not charges:
                # report at the def line so one pragma covers the helper
                out.append(self.finding(
                    src, fn,
                    f"{qual} fetches pages ("
                    + ", ".join(sorted({call_attr(n) for n in fetches}))
                    + ") but never charges a virtual-clock channel; "
                    "charge one or mark `# repro: allow-uncharged` if "
                    "the caller owns the charge"))
        return [f for f in out if f is not None]
