"""The dedup index build with its signature step on the card.

Alg. 1 (:meth:`Deduplicator.add_model`, ``core/dedup.py``, a verbatim
copy of the reference) asks for one block's L2-LSH signature at a time;
the Sec.-7.6 update (``update_model``) and the re-index of a reopened
store (``rebuild_index``) sign whole batches.  The classes here keep
that algorithm and move the signatures to the ``lsh_signature`` kernel:

  * :class:`DeviceL2LSH` signs a batch of numpy blocks in chunks staged
    through pinned memory, with the projections drawn by the host
    :class:`L2LSH` (numpy's ``default_rng(cfg.seed)``, so both packages
    hash with the same bits);
  * :class:`DeviceDeduplicator` signs a tensor's blocks in one batch the
    first time Alg. 1 queries one of them, and answers the per-block
    requests from those rows (one launch a chunk, not one a block);
  * :class:`DeviceModelStore` is a :class:`ModelStore` that dedups with
    it, also when ``ModelStore.open`` constructs it.

Index mode, as the serving tier's kernel mode (``serving.device_pool``):
``cuda`` is the kernel; ``torch`` the plain PyTorch version on
``device`` (the CPU unless one is given); ``host`` the copy's own numpy
routine, one block at a time, which is the reference's build exactly;
``auto`` = ``cuda``, and raises without a CUDA device of capability
(9, 0).  The mode is resolved at the first signature, so a store opened
only to serve needs no card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import ops, ref
from ..serving.device_pool import KERNEL_MODES, resolve_kernel_mode
from .dedup import DedupConfig, Deduplicator
from .lsh import L2LSH, LSHIndex
from .store import ModelStore, StoreConfig

__all__ = ["CHUNK_BLOCKS", "IndexStats", "DeviceL2LSH", "DeviceDeduplicator",
           "DeviceModelStore"]

#: blocks a launch signs: 1 GiB of pinned staging at 64x64 fp32 blocks
CHUNK_BLOCKS = 65536


@dataclasses.dataclass
class IndexStats:
    """What the index build cost, accumulated over a store's life."""
    blocks: int = 0                # blocks signed
    launches: int = 0              # lsh_signature kernel launches
    sign_device_seconds: float = 0.0   # kernel time (CUDA events)
    h2d_seconds: float = 0.0       # pinned -> device copies (CUDA events)
    sign_wall_seconds: float = 0.0     # host clock around every signing
    build_seconds: float = 0.0     # add/update/rebuild_index wall clock


def _check_mode(index_mode: str) -> str:
    if index_mode not in KERNEL_MODES:
        raise ValueError(f"unknown index_mode {index_mode!r}; "
                         f"have {KERNEL_MODES}")
    return index_mode


class DeviceL2LSH(L2LSH):
    """:class:`L2LSH` whose :meth:`signatures` run in ``mode``."""

    def __init__(self, host: L2LSH, mode: str = "auto", device=None,
                 stats: Optional[IndexStats] = None):
        # take the host instance's draws instead of drawing again
        # (L2LSH.__init__ is not called)
        self.cfg, self.dim = host.cfg, host.dim
        self.proj, self.bias = host.proj, host.bias
        self.mode = _check_mode(mode)
        self.device = device
        self.stats = stats if stats is not None else IndexStats()
        self._resolved: Optional[str] = None
        self._params = None            # (proj, bias) on the card
        self._staging: Optional[torch.Tensor] = None

    def resolved_mode(self) -> str:
        if self._resolved is None:
            self._resolved = resolve_kernel_mode(self.mode, self.device,
                                                 name="index_mode")
        return self._resolved

    def signatures(self, blocks: np.ndarray) -> np.ndarray:
        """``blocks``: [n, *block_shape] -> int32 signatures
        [n, num_hashes]."""
        mode = self.resolved_mode()
        t0 = time.perf_counter()
        if mode == "host":
            out = super().signatures(blocks)
        else:
            flat = np.asarray(blocks, dtype=np.float32).reshape(len(blocks),
                                                                -1)
            if flat.shape[1] != self.dim:
                raise ValueError(f"block dim {flat.shape[1]} != LSH dim "
                                 f"{self.dim}")
            out = self._sign_cuda(flat) if mode == "cuda" \
                else self._sign_torch(flat)
        self.stats.blocks += len(out)
        self.stats.sign_wall_seconds += time.perf_counter() - t0
        return out

    def _sign_torch(self, flat: np.ndarray) -> np.ndarray:
        dev = torch.device(self.device or "cpu")
        x, proj, bias = (torch.from_numpy(a).to(dev)
                         for a in (flat, self.proj, self.bias))
        return ref.lsh_signature(x, proj, bias, self.cfg.r).cpu().numpy()

    def _sign_cuda(self, flat: np.ndarray) -> np.ndarray:
        dev = torch.device(self.device or "cuda")
        if self._params is None:
            self._params = (torch.from_numpy(self.proj).to(dev),
                            torch.from_numpy(self.bias).to(dev))
        proj, bias = self._params
        n = len(flat)
        out = np.empty((n, self.cfg.num_hashes), dtype=np.int32)
        rows = min(n, CHUNK_BLOCKS)
        if self._staging is None or len(self._staging) < rows:
            self._staging = torch.empty((rows, self.dim), dtype=torch.float32,
                                        pin_memory=True)
        stage = self._staging.numpy()
        x = torch.empty((rows, self.dim), dtype=torch.float32, device=dev)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        for s in range(0, n, CHUNK_BLOCKS):
            m = min(CHUNK_BLOCKS, n - s)
            stage[:m] = flat[s:s + m]
            marks[0].record()
            x[:m].copy_(self._staging[:m], non_blocking=True)
            marks[1].record()
            sig = ops.lsh_signature(x[:m], proj, bias, self.cfg.r)
            marks[2].record()
            # the copy back waits for the kernel, so the staging buffer is
            # free again for the next chunk
            out[s:s + m] = sig.cpu().numpy()
            self.stats.h2d_seconds += marks[0].elapsed_time(marks[1]) / 1e3
            self.stats.sign_device_seconds += \
                marks[1].elapsed_time(marks[2]) / 1e3
            self.stats.launches += 1
        return out


class DeviceDeduplicator(Deduplicator):
    """:class:`Deduplicator` whose signatures come from
    :class:`DeviceL2LSH`, batched a tensor at a time."""

    def __init__(self, cfg: Optional[DedupConfig] = None,
                 index_mode: str = "auto", device=None):
        self.index_mode = _check_mode(index_mode)
        self.device = device
        self.index_stats = IndexStats()
        self._sigs: Dict[str, np.ndarray] = {}
        self._busy = False
        super().__init__(cfg)

    # Deduplicator.__init__ (dedup.py:76) and rebuild_index (:326) assign
    # an LSHIndex with a host L2LSH; the setter swaps in the device one
    @property
    def index(self) -> LSHIndex:
        return self._index

    @index.setter
    def index(self, index: LSHIndex) -> None:
        index.lsh = DeviceL2LSH(index.lsh, self.index_mode, self.device,
                                self.index_stats)
        self._index = index

    def set_index_mode(self, index_mode: str, device=None) -> None:
        self.index_mode = _check_mode(index_mode)
        self.device = device
        self.index = self.index

    def _timed(self, fn, *args, **kwargs):
        """Run a build step with a fresh signature cache; its wall time
        counts once, also where update_model (Approach 1) calls
        add_model."""
        nested, self._busy = self._busy, True
        self._sigs = {}
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._sigs = {}
            self._busy = nested
            if not nested:
                self.index_stats.build_seconds += time.perf_counter() - t0

    def add_model(self, *args, **kwargs):
        return self._timed(super().add_model, *args, **kwargs)

    def update_model(self, *args, **kwargs):
        return self._timed(super().update_model, *args, **kwargs)

    def rebuild_index(self) -> None:
        return self._timed(super().rebuild_index)

    def _signature(self, blocked: Dict[str, np.ndarray], name: str,
                   bid: int) -> np.ndarray:
        """Block ``bid``'s signature, from its tensor's batch.

        The batch is signed at the tensor's first query.  Exact with
        respect to Alg. 1: a block's contents change only where it is
        replaced by a representative -- after its own query (dedup.py:215)
        or, in ``update_model``, as an unchanged block that is never
        queried (:299) -- so every block queried is signed with its
        original contents."""
        sigs = self._sigs.get(name)
        if sigs is None:
            sigs = self._sigs[name] = self.index.lsh.signatures(blocked[name])
        return sigs[bid]

    def _dedup_one(self, model, res, blocked, name, bid) -> None:
        if self.index.lsh.resolved_mode() == "host":
            return super()._dedup_one(model, res, blocked, name, bid)
        # dedup.py:202-220, the signature read from the tensor's batch
        block = blocked[name][bid]
        t0 = time.perf_counter()
        sig = self._signature(blocked, name, bid)
        gid = self.index.query(sig)
        res.index_query_seconds += time.perf_counter() - t0
        ref_ = (model, name)
        member = (model, name, bid)
        if gid is not None:
            did = self._gid_to_did[gid]
            self.index.add_member(gid, member)
            self._add_ref(did, ref_)
            blocked[name][bid] = self.distinct[did]      # replace by rep
            res.tensors[name].block_map[bid] = did
            res.deduped_blocks += 1
        else:
            res.tensors[name].block_map[bid] = \
                self._new_distinct(block, ref_, sig, member)

    def _index_as_distinct(self, model, res, blocked, name, bid) -> None:
        if self.index.lsh.resolved_mode() == "host":
            return super()._index_as_distinct(model, res, blocked, name, bid)
        # dedup.py:222-228, the signature read from the tensor's batch
        block = blocked[name][bid]
        sig = self._signature(blocked, name, bid)
        res.tensors[name].block_map[bid] = self._new_distinct(
            block, (model, name), sig, (model, name, bid))


class DeviceModelStore(ModelStore):
    """:class:`ModelStore` whose dedup index is built by
    :class:`DeviceDeduplicator` in ``index_mode`` (default ``auto``: the
    card)."""

    def __init__(self, cfg: Optional[StoreConfig] = None, *,
                 index_mode: str = "auto", device=None):
        super().__init__(cfg)
        self.dedup = DeviceDeduplicator(self.cfg.dedup, index_mode, device)

    @classmethod
    def open(cls, source, cfg: Optional[StoreConfig] = None, *,
             index_mode: str = "auto", device=None) -> "DeviceModelStore":
        """:meth:`ModelStore.open`, which constructs ``cls(cfg)``
        (store.py:698); the index mode is set on the opened store."""
        store = super().open(source, cfg)
        store.dedup.set_index_mode(index_mode, device)
        return store
