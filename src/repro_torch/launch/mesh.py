"""Meshes: the production meshes of the dry-run and the serving mesh of a
sharded page pool, and the device of each shard.

Counterpart of ``repro.launch.mesh``.  JAX's ``Mesh`` is one
controller's view of many devices; a torch ``DeviceMesh`` has one rank a
process.  So:

* :func:`make_production_mesh` and :func:`make_mini_mesh` return a
  ``DeviceMesh`` of the reference's shapes and axis names over a *fake*
  world (``torch.distributed``'s ``fake`` backend, one rank standing for
  all): ranks exist only as a size, collectives move nothing, and the
  dry-run traces each rank's share of the step on fake tensors.  The mesh
  is labelled ``cpu`` on every machine, so a dry-run record does not
  depend on where it was made.  Each process holds one default group, so
  a process makes one world size (the dry-run spawns a process a cell,
  as the reference does).
* :func:`make_shard_mesh` is the single controller's serving mesh: a
  ``("shard",)`` mesh over a real one-rank group (NCCL on a card, gloo
  on the CPU), clamped as the reference clamps it to local devices.
* :func:`shard_devices` places shard i's slab, as before.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..serving.device_pool import resolve_kernel_mode

__all__ = ["fake_world", "make_mini_mesh", "make_production_mesh",
           "make_shard_mesh", "shard_devices"]

#: the label of the dry-run's fake meshes (see the module docstring)
FAKE_DEVICE = "cpu"


def fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0), unless one of that size exists.  Raises if
    a group of another size or backend already holds the process."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size or \
                dist.get_backend() != "fake":
            raise RuntimeError(
                f"fake_world({world_size}): this process already holds a "
                f"{dist.get_backend()} group of {dist.get_world_size()} "
                "ranks; run each world size in its own process")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:       # pragma: no cover - torch without it
        raise RuntimeError(
            f"the dry-run needs torch.distributed's fake backend "
            f"(torch.testing._internal.distributed.fake_pg), which torch "
            f"{torch.__version__} lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(math.prod(shape))
    return init_device_mesh(FAKE_DEVICE, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod (a
    fake world of that size)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _fake_mesh(shape, axes)


def make_mini_mesh(*, multi_pod: bool = False, devices_per_axis: int = 2):
    """Reduced mesh for CI-scale dry-run tests (a fake world of 4 or 8)."""
    d = devices_per_axis
    shape = (2, d, d) if multi_pod else (d, d)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _fake_mesh(shape, axes)


# ------------------------------------------------------------ serving mesh --
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


def _local_group(device_type: str) -> None:
    """A real one-rank default group (NCCL on the card, gloo on the CPU)
    unless the process already holds one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_shard_mesh(num_shards: int, kernel_mode: str = "auto"):
    """1-D ``("shard",)`` mesh for sharded page-pool serving.  The axis is
    clamped to the cards this process's group reaches (one rank a
    process: a single controller gets a 1-device mesh, so a 4-shard pool
    on one card is a 1-device mesh with all four slabs co-located); the
    per-shard pools still pin to :func:`shard_devices`.  The reference
    takes no ``kernel_mode``: here it picks the card (cuda) or the CPU
    (torch, host), as :func:`shard_devices` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    mode = resolve_kernel_mode(kernel_mode)
    device_type = "cuda" if mode == "cuda" else "cpu"
    _local_group(device_type)
    cards = torch.cuda.device_count() if device_type == "cuda" else 1
    n = max(1, min(int(num_shards), cards, dist.get_world_size()))
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=("shard",))
