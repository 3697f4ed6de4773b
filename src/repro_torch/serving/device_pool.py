"""Device-resident page pool: the HBM tier of the paper's buffer pool.

Counterpart of ``repro.serving.device_pool``.  The paper pages
deduplicated blocks between disk and DRAM; on a GPU the same two tiers
are host DRAM (the ModelStore's distinct-block arrays) and HBM
(DESIGN.md §2).  :class:`DevicePagePool` is the HBM side:

  * a **fixed preallocated slab** ``[capacity_pages + stage_rows,
    blocks_per_page, bh, bw]``, a torch tensor on the pool's device —
    page loads are real host->device copies committed with
    ``index_copy_``; the ``stage_rows`` past ``capacity`` are the
    borrow-staging tail of a sharded pool (:meth:`write_stage`);
  * a **physical->slot remap**: :meth:`remap` rewrites a
    ``ModelStore.virtual_tensor`` flat block map (physical slot space,
    ``page * l + slot``) into slab-slot space (``slab_slot * l + slot``)
    with one vectorized lookup, cached per (packing, slab) generation;
  * **compute entry points** — :meth:`gather_rows`, :meth:`virtual_matmul`,
    :meth:`unblock` — that run the dedup kernels directly against the
    resident slab, so inference never densifies weights on the host.

The pool is driven by :class:`~repro_torch.core.bufferpool.BufferPool`
through its ``on_load``/``on_evict`` callbacks: the policy simulator
stays the single source of truth for *which* pages are resident, and
this class keeps the invariant ``slab occupied slots == pool resident
set``.

Kernel mode — how :meth:`gather_rows` / :meth:`virtual_matmul` execute:

  * ``"cuda"``: the slab lives on a CUDA device and the hand-written
    Hopper kernels (``repro_torch.kernels.ops``) compute from it.
  * ``"torch"``: the plain PyTorch versions (``kernels.ref``) against a
    slab on the pool's device, the CPU unless one is given — the
    counterpart of the reference's ``xla`` mode and the kernels' oracle.
  * ``"host"``: numpy gathers against the *host mirror*, a numpy array
    of the slab's shape that takes the tensor slab's place (each mode
    keeps exactly one backing store).
  * ``"auto"`` (default): ``cuda``.  It raises ``RuntimeError`` when no
    CUDA device of compute capability (9, 0) is present — there is no
    silent CPU fallback; a CPU caller asks for ``torch`` or ``host``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.blocks import BlockGrid
from ..core.store import ModelStore, VirtualTensor
from ..kernels import ops, ref
from ..obs import get_tracer
from .transfer import TransferEngine

__all__ = ["DevicePagePool", "KERNEL_MODES", "resolve_kernel_mode"]

KERNEL_MODES = ("auto", "cuda", "torch", "host")
#: the GPU the hand-written kernels are built for (Hopper, sm_90a)
CUDA_CAPABILITY = (9, 0)


def resolve_kernel_mode(kernel_mode: str, device=None,
                        name: str = "kernel_mode") -> str:
    """``auto`` -> ``cuda`` when a CUDA device of capability (9, 0) is
    present; raise otherwise.  Other modes pass through.  ``name`` is
    the caller's parameter, for the messages."""
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"unknown {name} {kernel_mode!r}; "
                         f"have {KERNEL_MODES}")
    if kernel_mode != "auto":
        return kernel_mode
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{name}='auto' means the CUDA kernels, and no CUDA device "
            f"is present; pass {name}='torch' or 'host' to run on "
            "the CPU")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != CUDA_CAPABILITY:
        raise RuntimeError(
            f"{name}='auto' means the sm_90a kernels, and the CUDA "
            f"device has capability {tuple(cap)}, not {CUDA_CAPABILITY}")
    return "cuda"


def _pad_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


class DevicePagePool:
    """Fixed-capacity device slab of deduplicated pages + slot remap."""

    def __init__(self, store: ModelStore, capacity_pages: int,
                 dtype=torch.float32, kernel_mode: str = "auto",
                 device=None, stage_rows: int = 0):
        self.kernel_mode = kernel_mode
        self._mode = resolve_kernel_mode(kernel_mode, device)
        self.store = store
        bh, bw = store.cfg.dedup.block_shape
        self.block_shape = (bh, bw)
        self.blocks_per_page = store.cfg.blocks_per_page
        self.capacity = int(capacity_pages)
        # Borrow-staging tail (sharded serving): ``stage_rows`` page rows
        # past the resident slots, written only by :meth:`write_stage`.
        # Extended remaps point borrowed pages at ``capacity + stage_idx``,
        # so the kernels read one stable buffer.  No load, group commit
        # or free slot ever lands there (``_free`` covers ``capacity``).
        self.stage_rows = int(stage_rows)
        self.dtype = dtype
        self.device = self._resolve_device(device)
        rows = self.capacity + self.stage_rows
        # One backing store per mode: the preallocated tensor slab, or,
        # in host mode, its numpy counterpart (the host tier itself).
        shape = (rows, self.blocks_per_page, bh, bw)
        self.slab = None if self._mode == "host" else torch.zeros(
            shape, dtype=dtype, device=self.device)
        self.host_slab = np.zeros(shape, np.float32) \
            if self._mode == "host" else None
        self.slot_of: Dict[int, int] = {}        # physical page id -> slot
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        # page id -> slot as an int64 array (-1 = absent), maintained O(1)
        # per load/evict so per-batch remaps are pure vectorized lookups
        self._page_to_slot = np.full(store.packing.num_pages, -1,
                                     dtype=np.int64)
        self.generation = 0                      # bumped on load/evict/flush
        self.loads = 0
        self.evicts = 0
        # (model, tensor) -> (pack_gen, slab_gen, dev_map np.int32,
        #                     complete: no -1 holes)
        self._remap_cache: Dict[Tuple[str, str],
                                Tuple[int, int, np.ndarray, bool]] = {}
        # Batched/overlapped host->device movement (DESIGN.md §6): the
        # buffer pool's on_load_group callback lands in load_group().
        self.transfer = TransferEngine(self)
        if self._mode == "cuda":
            self.transfer.warm()

    def _resolve_device(self, device) -> Optional[torch.device]:
        if self._mode == "host":
            return None
        if self._mode == "cuda":
            dev = torch.device(device) if device is not None else \
                torch.device("cuda", torch.cuda.current_device())
            if dev.type != "cuda":
                raise ValueError(f"kernel_mode='cuda' needs a CUDA device, "
                                 f"got {dev}")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            return dev
        return torch.device(device) if device is not None \
            else torch.device("cpu")

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A small host index array on the pool's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------ page movement --
    def load(self, pid: int) -> None:
        """BufferPool ``on_load``: transfer one page host->device into a
        free slab slot.  In host mode the mirror *is* the device tier.

        ``store.page_array`` sources the page through the store's
        attached :class:`~repro_torch.storage.PageBackend` when one is
        present, so slab faults reach all the way down to the storage
        tier."""
        if pid in self.slot_of:
            return
        with get_tracer().span("page_load", kind="transfer",
                               pid=int(pid), pages=1):
            # fetch BEFORE taking a slot: a storage fault mid-fetch must
            # not leak a free slot (exception safety under fault injection)
            page = self.store.page_array(pid, dtype=np.float32)
            slot = self._free.pop()
            # time only the host->device leg: page_array may have faulted
            # the storage backend, which must never leak into the fitted
            # channel
            cuda = self._mode == "cuda"
            start = None if cuda else self.transfer.start_timer()
            if self._mode == "host":
                # repro: allow-slab-write (the pool's own page-load bookkeeping)
                self.host_slab[slot] = page
            else:
                host = self.transfer.host_tensor(page[None])
                slot_t = self._put(np.array([slot]))
                buf = self.transfer.device_buffer(host.shape)
                if cuda:
                    start = self.transfer.start_timer()
                self.slab.index_copy_(0, slot_t,
                                      self.transfer.ship(host, buf))
            self.slot_of[pid] = slot
            self._page_to_slot[pid] = slot
            self.generation += 1
            self.loads += 1
            self.transfer.stop_timer(start, 1)

    def load_group(self, pids) -> None:
        """BufferPool ``on_load_group``: transfer a whole group of pages
        host->device as ONE staged stack + one ``index_copy_`` + one
        generation bump.  Pages prestaged by the engine's double buffer
        commit from the already in-flight device bytes."""
        self.transfer.load_group(pids)

    def evict(self, pid: int) -> None:
        """BufferPool ``on_evict``: release the page's slot.  The slab
        bytes are left in place — a slot without a slot_of entry is
        unreachable through any remap, so no scrub is needed."""
        slot = self.slot_of.pop(pid, None)
        if slot is None:
            return
        self._free.append(slot)
        self._page_to_slot[pid] = -1
        self.generation += 1
        self.evicts += 1

    def flush(self) -> None:
        """Forget every resident page (store repacked: page ids renamed,
        and the page-id universe may have changed size)."""
        self.slot_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._page_to_slot = np.full(self.store.packing.num_pages, -1,
                                     dtype=np.int64)
        self._remap_cache.clear()
        self.transfer.drop_pending()             # staged bytes are stale too
        self.generation += 1

    # ----------------------------------------------------------- queries --
    def resident_pages(self) -> Set[int]:
        return set(self.slot_of)

    def occupied_slots(self) -> Set[int]:
        return set(self.slot_of.values())

    def flat_pool(self) -> torch.Tensor:
        """Kernel view of the slab, its staging tail included:
        [(capacity + stage_rows) * blocks_per_page, bh, bw]."""
        bh, bw = self.block_shape
        return self.slab.view(self.slab.shape[0] * self.blocks_per_page,
                              bh, bw)

    def write_stage(self, stage_slots, rows) -> None:
        """Write pages into the borrow-staging tail: ``rows[i]`` lands in
        tail slot ``stage_slots[i]``, slab row ``capacity +
        stage_slots[i]``.  The tail's only writer.  ``rows`` is a tensor
        (moved to the pool's device and dtype, committed with one
        ``index_copy_``) in cuda and torch mode, an array in host mode.
        Residency and the remap generation are untouched: no remap points
        at a tail row but the sharded pool's per-batch extended one."""
        idx = np.asarray(stage_slots, np.int64)
        if not len(idx):
            return
        if idx.min() < 0 or idx.max() >= self.stage_rows:
            raise IndexError(f"staging slots {idx.min()}..{idx.max()} "
                             f"outside the tail of {self.stage_rows}")
        idx = idx + self.capacity
        if self._mode == "host":
            # repro: allow-slab-write (the staging tail's one writer)
            self.host_slab[idx] = rows
            return
        self.slab.index_copy_(0, self._put(idx),
                              rows.to(self.device, self.dtype))

    def slot_page(self, slot: int) -> np.ndarray:
        """Host copy of one slab slot (tests / debugging)."""
        if self._mode == "host":
            return self.host_slab[slot].copy()
        return self.slab[slot].float().cpu().numpy()

    def mode(self) -> str:
        """Resolved compute mode: cuda | torch | host."""
        return self._mode

    # ------------------------------------------------------------- remap --
    def remap(self, vt: VirtualTensor,
              key: Optional[Tuple[str, str]] = None,
              strict: bool = True) -> Optional[np.ndarray]:
        """Rewrite a virtual tensor's physical flat block map into slab
        slot space with one vectorized lookup (cached per packing + slab
        generation under ``key``).

        ``strict=True`` returns None when *any* of the tensor's pages is
        not resident (whole-tensor consumers: unblock / virtual_matmul).
        ``strict=False`` returns the map with ``-1`` holes for absent
        pages — a row-gather caller that has already faulted its batch's
        pages (and verified them via :meth:`pages_resident`) only touches
        resident entries, so partial residency still serves off the slab.
        """
        hit = self._remap_cache.get(key) if key is not None else None
        if hit is not None and hit[0] == self.store.pack_generation \
                and hit[1] == self.generation:
            dev_map, complete = hit[2], hit[3]
        else:
            l = self.blocks_per_page
            slots = self._page_to_slot[vt.block_map // l]
            holes = slots < 0
            dev_map = np.where(holes, -1,
                               slots * l + vt.block_map % l).astype(np.int32)
            complete = not holes.any()
            if key is not None:
                self._remap_cache[key] = (self.store.pack_generation,
                                          self.generation, dev_map, complete)
        if strict and not complete:
            return None
        return dev_map

    def pages_resident(self, pages) -> bool:
        return all(p in self.slot_of for p in pages)

    # ------------------------------------------------------------ compute --
    def gather_rows(self, dev_map: np.ndarray, grid: BlockGrid,
                    rows: np.ndarray, pad: bool = False):
        """Rows of the virtual 2-D tensor, gathered from the resident
        slab.  cuda mode runs the ``dedup_embedding`` kernel (every
        column stripe in one launch); torch mode its plain version; host
        mode a numpy fancy-index gather from the slab mirror (returns
        np.ndarray).

        In the tensor modes ``rows`` is padded to a power-of-two bucket
        so downstream shapes stay stable; ``pad=True`` returns the padded
        ``[bucket, width]`` tensor (rows past ``n`` repeat a requested
        row) — indices into the first ``n`` rows are unaffected."""
        bh, bw = self.block_shape
        gh, gw = grid.grid
        width = grid.shape2d[1]
        rows = np.asarray(rows)
        n = len(rows)
        bmap2d = dev_map.reshape(gh, gw)
        # Partial remaps carry -1 holes; a negative index would read the
        # wrong slab bytes, so a touched hole (the caller's page set
        # failed to cover its rows) must surface as None — the engines
        # then take the host fallback instead of serving garbage.
        if n and (bmap2d[np.unique(rows // bh)] < 0).any():
            return None
        mode = self._mode
        l = self.blocks_per_page
        if mode == "host":
            with get_tracer().span("kernel", kind="kernel",
                                   op="gather_rows", mode=mode, rows=n):
                slab = self.host_slab
                flat_rows = slab.reshape(slab.shape[0] * l * bh, bw)
                rb, off = rows // bh, rows % bh
                out = flat_rows[bmap2d[rb] * bh + off[:, None]]  # [n,gw,bw]
                return out.reshape(n, gw * bw)[:, :width]
        # Pad with a *requested* row, not row 0: under partial residency
        # row 0's block may be absent and must never be touched.
        ids = np.full(_pad_pow2(max(n, 1)), rows[0] if n else 0, np.int32)
        ids[:n] = rows
        with get_tracer().span("kernel", kind="kernel", op="gather_rows",
                               mode=mode, rows=n):
            pool = self.flat_pool()
            ids_t = self._put(ids)
            bmap_t = self._put(bmap2d.astype(np.int32))
            if mode == "cuda":
                out = ops.dedup_embedding_striped(ids_t, pool, bmap_t,
                                                  width=width)
            else:
                out = ref.dedup_embedding_striped(ids_t, pool, bmap_t,
                                                  width=width)
        return out if pad else out[:n]

    def virtual_matmul(self, dev_map: np.ndarray, grid: BlockGrid, x):
        """``x @ W_virtual`` with W never densified on the host: the
        ``dedup_matmul`` kernel streams slab blocks through the block map
        (cuda); torch mode runs its plain version against the slab; host
        mode runs the same k-loop blockwise in numpy against the mirror."""
        bh, bw = self.block_shape
        gh, gw = grid.grid
        K, N = grid.shape2d
        bmap2d = dev_map.reshape(gh, gw)
        mode = self._mode
        l = self.blocks_per_page
        if mode == "host":
            slab = self.host_slab
            blocks = slab.reshape(slab.shape[0] * l, bh, bw)
            x = np.asarray(x, dtype=np.float32)
            xp = x
            if x.shape[-1] != gh * bh:
                if x.shape[-1] != K:
                    raise ValueError(f"x has {x.shape[-1]} features, the "
                                     f"tensor has {K} rows")
                xp = np.zeros(x.shape[:-1] + (gh * bh,), np.float32)
                xp[..., :K] = x
            y = np.zeros(x.shape[:-1] + (gw * bw,), np.float32)
            for j in range(gw):                  # the kernel's (j, k) loops
                acc = y[..., j * bw:(j + 1) * bw]
                for k in range(gh):
                    acc += xp[..., k * bh:(k + 1) * bh] \
                        @ blocks[bmap2d[k, j]]
            return y[..., :N]
        with get_tracer().span("kernel", kind="kernel",
                               op="virtual_matmul", mode=mode):
            x = torch.as_tensor(x, device=self.device)
            if x.dtype not in (torch.float32, torch.bfloat16):
                x = x.to(self.dtype)
            pad = gh * bh - x.shape[-1]
            if pad:
                if x.shape[-1] != K:
                    raise ValueError(f"x has {x.shape[-1]} features, the "
                                     f"tensor has {K} rows")
                x = torch.nn.functional.pad(x, (0, pad))
            pool = self.flat_pool()
            bmap_t = self._put(bmap2d.astype(np.int32))
            if mode == "cuda":
                y = ops.dedup_matmul(x.contiguous(), pool, bmap_t)
            else:
                y = ref.dedup_matmul(x, pool, bmap_t)
            return y[..., :N]

    def unblock(self, dev_map: np.ndarray, grid: BlockGrid):
        """Full tensor reassembled from resident slab blocks (the LM
        model-switch path; np from the mirror in host mode, a tensor on
        the pool's device otherwise)."""
        l = self.blocks_per_page
        bh, bw = self.block_shape
        mode = self._mode
        with get_tracer().span("kernel", kind="kernel", op="unblock",
                               mode=mode):
            if mode == "host":
                from ..core.blocks import unblock_tensor
                slab = self.host_slab
                blocks = slab.reshape(slab.shape[0] * l, bh, bw)[dev_map]
                return unblock_tensor(blocks, grid)
            gh, gw = grid.grid
            K, N = grid.shape2d
            W = ref.materialize_virtual(self.flat_pool(),
                                        self._put(dev_map.reshape(gh, gw)),
                                        K, N)
            return W.reshape(grid.tensor_shape)

