"""Device assignment for sharded serving.

Counterpart of ``shard_devices`` in ``repro.launch.mesh``.  The rest of
that module (production meshes, the serving mesh a stacked slab is laid
out over) belongs to the port's distribution slice.
"""
from __future__ import annotations

from typing import List

import torch

from ..serving.device_pool import resolve_kernel_mode

__all__ = ["shard_devices"]


def shard_devices(num_shards: int, kernel_mode: str = "auto"
                  ) -> List[torch.device]:
    """Where each shard of a sharded page pool keeps its slab: shard i on
    CUDA device ``i % device_count`` in cuda mode (so on one GPU every
    shard shares ``cuda:0``), the CPU in the torch and host modes.
    ``auto`` resolves as the device pool does, and raises without a
    CUDA device of capability (9, 0)."""
    mode = resolve_kernel_mode(kernel_mode)
    if mode != "cuda":
        return [torch.device("cpu")] * int(num_shards)
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(int(num_shards))]
