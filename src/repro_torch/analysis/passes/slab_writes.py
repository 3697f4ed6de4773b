"""slab-write: the grouped-transfer bypass lint.

Counterpart of ``repro.analysis.passes.slab_writes``, keyed to the
port's transfer layer, which also flags torch's in-place writes
(``index_copy_``, ``index_put_``, ``copy_``, ``scatter_``,
``index_fill_``, ``masked_scatter_``) on a receiver that mentions a
slab: the reference pass sees only subscript assignment.

The contract: all device-slab mutation funnels through
``TransferEngine`` (one staged stack -> one ``slab.index_copy_``
scatter -> ONE generation bump) or ``DevicePagePool``'s own
load/evict/flush bookkeeping.  An in-place write into a slab (or a
host-mirror ``host_slab[...] = ...`` assignment, ``slab.at[...].set``,
or ``dynamic_update_slice`` on a slab) anywhere else silently bypasses
generation accounting: remaps built before the write keep validating,
and readers gather stale rows.

Suppress a deliberate site with ``# repro: allow-slab-write``.
"""
from __future__ import annotations

import ast
from typing import List

from ..lint import Finding, LintPass, Source
from .common import call_attr, expr_names

__all__ = ["SlabWritePass"]

# modules that OWN slab mutation (the transfer/bookkeeping layer)
DEFAULT_OWNERS = (
    "repro_torch/serving/transfer.py",
    "repro_torch/serving/device_pool.py",
    "repro_torch/serving/shard_pool.py",
)
# torch's in-place writes into their receiver
INPLACE_WRITES = {"index_copy_", "index_put_", "copy_", "scatter_",
                  "index_fill_", "masked_scatter_"}


def _mentions_slab(node: ast.AST) -> bool:
    return any("slab" in n for n in expr_names(node))


class SlabWritePass(LintPass):
    """Flags direct slab writes outside the transfer layer."""
    name = "slab-write"
    pragma = "allow-slab-write"
    description = ("direct device-slab writes outside the "
                   "TransferEngine/DevicePagePool mutation layer")

    def __init__(self, owners=DEFAULT_OWNERS):
        self.owners = tuple(owners)

    def run(self, src: Source) -> List[Finding]:
        if src.endswith(*self.owners):
            return []
        out: List[Finding] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                attr = call_attr(node)
                # slab.at[slots].set(values)
                if (attr == "set"
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Subscript)
                        and isinstance(node.func.value.value, ast.Attribute)
                        and node.func.value.value.attr == "at"
                        and _mentions_slab(node.func.value.value.value)):
                    out.append(self.finding(
                        src, node,
                        "direct slab.at[...].set bypasses the grouped "
                        "TransferEngine scatter + generation bump"))
                # jax.lax.dynamic_update_slice(slab, ...)
                elif (attr == "dynamic_update_slice"
                        and any(_mentions_slab(a) for a in node.args)):
                    out.append(self.finding(
                        src, node,
                        "dynamic_update_slice on a slab bypasses the "
                        "grouped TransferEngine scatter"))
                # slab.index_copy_(0, slots, rows) and the like
                elif (attr in INPLACE_WRITES
                        and isinstance(node.func, ast.Attribute)
                        and _mentions_slab(node.func.value)):
                    out.append(self.finding(
                        src, node,
                        f"in-place slab.{attr} bypasses the grouped "
                        "TransferEngine scatter + generation bump"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and _mentions_slab(t.value):
                        out.append(self.finding(
                            src, node,
                            "in-place slab/mirror write outside the "
                            "transfer layer skips generation accounting"))
                        break
        return [f for f in out if f is not None]
