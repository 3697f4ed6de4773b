"""host-sync: no host materialization in serving hot paths.

Counterpart of ``repro.analysis.passes.host_sync``, keyed to the port's
serving modules.  The serving compute path is virtual-clock driven:
real device work is overlapped, so an unannotated host sync in a hot
path serializes the very transfers the timeline claims to overlap.  The
pass bans, inside a configured set of hot ``Class.method`` qualnames per
module, the reference's host syncs (``np.asarray``, ``.item()``,
``float(dev_scalar)``, ...) and torch's: ``.cpu()``, ``.numpy()``,
``.tolist()``, ``torch.cuda.synchronize()`` and ``.synchronize()`` on an
event or a stream.  Deliberate host hops (the host-mirror mode, a
small index array read back once) carry ``# repro: allow-host`` pragmas
documenting why the sync is safe.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..lint import Finding, LintPass, Source
from .common import call_attr, call_root, iter_functions

__all__ = ["HostSyncPass", "DEFAULT_HOT_PATHS"]

BANNED_ATTRS = {"asarray", "ascontiguousarray", "device_get",
                "block_until_ready", "item",
                # torch: each one waits for the device
                "cpu", "numpy", "tolist", "synchronize"}
BANNED_NAMES = {"float"}
# roots whose .asarray IS host materialization (torch.asarray stays put)
HOST_ROOTS = {"np", "numpy", "onp"}

# module suffix -> hot Class.method qualnames (the demand serve path)
DEFAULT_HOT_PATHS: Dict[str, Set[str]] = {
    "repro_torch/serving/device_pool.py": {
        "DevicePagePool.load", "DevicePagePool.load_group",
        "DevicePagePool.evict", "DevicePagePool.remap",
        "DevicePagePool.gather_rows", "DevicePagePool.virtual_matmul",
        "DevicePagePool.unblock",
    },
    "repro_torch/serving/transfer.py": {
        "TransferEngine.stage", "TransferEngine.load_group",
        "TransferEngine.record_single",
    },
    "repro_torch/serving/shard_pool.py": {
        "ShardedPagePool.stage_borrows", "ShardedPagePool._sync_stage",
        "ShardedPagePool.remap", "ShardedPagePool.gather_rows",
        "ShardedPagePool.virtual_matmul", "ShardedPagePool.unblock",
        "ShardedWeightServer.access_pages",
        "ShardedWeightServer.access_pages_grouped",
        "ShardedWeightServer.device_gather_rows",
        "ShardedWeightServer.device_matmul",
        "ShardedWeightServer.device_tensor",
        "ShardedWeightServer.prestage",
    },
    "repro_torch/serving/engine.py": {
        "WeightServer.access_pages", "WeightServer.access_pages_grouped",
        "WeightServer.prestage", "WeightServer.device_gather_rows",
        "WeightServer.device_matmul", "WeightServer.device_tensor",
        "EmbeddingServingEngine._infer", "LMServingEngine._compute",
    },
}


class HostSyncPass(LintPass):
    """Flags host materialization inside configured hot paths."""
    name = "host-sync"
    pragma = "allow-host"
    description = ("host materialization (np.asarray/.cpu()/.numpy()/"
                   ".tolist()/.item()/synchronize/float) in serving hot "
                   "paths")

    def __init__(self, hot: Optional[Dict[str, Set[str]]] = None):
        self.hot = DEFAULT_HOT_PATHS if hot is None else hot

    def _hot_quals(self, src: Source) -> Optional[Set[str]]:
        for suffix, quals in self.hot.items():
            if src.path.endswith(suffix):
                return quals
        return None

    def run(self, src: Source) -> List[Finding]:
        quals = self._hot_quals(src)
        if not quals:
            return []
        out: List[Finding] = []
        for qual, fn in iter_functions(src.tree):
            if qual not in quals:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = call_attr(node)
                root = call_root(node)
                bad = None
                if attr in BANNED_ATTRS:
                    if attr in ("asarray", "ascontiguousarray") \
                            and root not in HOST_ROOTS:
                        continue          # torch.asarray etc. stays put
                    bad = attr
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in BANNED_NAMES:
                    bad = node.func.id
                if bad is not None:
                    out.append(self.finding(
                        src, node,
                        f"host sync `{bad}` inside hot path {qual}; "
                        "annotate deliberate host hops with "
                        "`# repro: allow-host`"))
        return [f for f in out if f is not None]
