"""Device-resident page pool: the HBM tier of the paper's buffer pool.

Counterpart of ``repro.serving.device_pool``.  The paper pages
deduplicated blocks between disk and DRAM; on a GPU the same two tiers
are host DRAM (the ModelStore's distinct-block arrays) and HBM
(DESIGN.md §2).  :class:`DevicePagePool` is the HBM side:

  * a **fixed preallocated slab** ``[capacity_pages + stage_rows,
    blocks_per_page, bh, bw]``, a torch tensor on the pool's device —
    page loads are real host->device copies committed with
    ``index_copy_``; the ``stage_rows`` past ``capacity`` are the
    staging tail (:meth:`write_stage`): a sharded pool's borrows, and
    in its last ``overflow_rows`` the pages a compute call needs that
    the buffer pool did not leave resident (a batch or a model switch
    larger than the slab);
  * a **physical->slot remap**: :meth:`remap` rewrites a
    ``ModelStore.virtual_tensor`` flat block map (physical slot space,
    ``page * l + slot``) into slab-slot space (``slab_slot * l + slot``)
    with one vectorized lookup, cached per (packing, slab) generation;
  * **compute entry points** — :meth:`gather_rows`, :meth:`virtual_matmul`,
    :meth:`unblock` — that run the dedup kernels directly against the
    resident slab, so inference never densifies weights on the host.
    Given the tensor's physical ``block_map``, a map with holes (pages
    not resident) is served through the overflow tail: the call's
    missing pages are written there and the same kernel reads a map
    into slab + tail, in chunks that each fit (page groups for a gather
    and for :meth:`unblock`, each missing page staged once; K ranges
    summed in fp32 for a product).  The tail is outside the buffer
    pool: it changes no residency, hit or eviction, and no remap
    generation.

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

__all__ = ["DevicePagePool", "KERNEL_MODES", "TAIL_PAGES",
           "resolve_kernel_mode", "tail_size"]

KERNEL_MODES = ("auto", "cuda", "torch", "host")
#: the GPU the hand-written kernels are built for (Hopper, sm_90a)
CUDA_CAPABILITY = (9, 0)
#: overflow-tail pages of a serving slab, at most half its capacity.  A
#: call whose missing pages exceed it is served in chunks, so the size
#: trades chunks for device memory; ``chip_smoke.py``'s ``[pressure]``
#: sweep times 8, 32 and 64 pages on the H100.
TAIL_PAGES = 32


def tail_size(capacity_pages: int) -> int:
    """Overflow-tail pages for a slab of ``capacity_pages``:
    :data:`TAIL_PAGES`, at most half the slab, at least 1."""
    return max(1, min(TAIL_PAGES, int(capacity_pages) // 2))


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
                 device=None, stage_rows: int = 0, overflow_rows: int = 0):
        self.kernel_mode = kernel_mode
        self._mode = resolve_kernel_mode(kernel_mode, device)
        self.store = store
        bh, bw = store.cfg.dedup.block_shape
        self.block_shape = (bh, bw)
        self.blocks_per_page = store.cfg.blocks_per_page
        self.capacity = int(capacity_pages)
        # Staging tail: ``stage_rows`` page rows past the resident slots,
        # written only by :meth:`write_stage`.  Extended remaps point a
        # sharded pool's borrowed pages at ``capacity + stage_idx``, so
        # the kernels read one stable buffer.  No load, group commit or
        # free slot ever lands there (``_free`` covers ``capacity``).
        # The last ``overflow_rows`` of it take the pages a compute call
        # needs that the buffer pool did not leave resident.
        self.stage_rows = int(stage_rows)
        self.overflow_rows = int(overflow_rows)
        if not 0 <= self.overflow_rows <= self.stage_rows:
            raise ValueError(f"overflow_rows {overflow_rows} outside the "
                             f"staging tail of {stage_rows}")
        self._overflow0 = self.stage_rows - self.overflow_rows
        # compute calls served through the overflow tail, their kernel
        # calls (a chunk each), and the tail writes and pages they made
        self.tail_calls = 0
        self.tail_chunks = 0
        self.tail_writes = 0
        self.tail_staged = 0
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
        not resident.  ``strict=False`` returns the map with ``-1`` holes
        for absent pages: the compute entry points, given the tensor's
        physical block map, serve those through the overflow tail.
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

    # ------------------------------------------------------ overflow tail --
    # The compute call is not a fetch of its own: the engines charged its
    # pages at their access, as the reference charges the host path that
    # reads them (nothing more for a batch, the fault cursor for a model
    # switch).  The copy's time shows in the tail counters.
    # repro: allow-uncharged
    def _write_overflow(self, pages: np.ndarray) -> np.ndarray:
        """Write ``pages`` (at most ``overflow_rows``) into the overflow
        tail in one upload and one ``index_copy_``; returns the slab row
        each landed in.  The stream orders the write after the kernels
        that read the tail before it."""
        stack = self.store.page_stack(pages, dtype=np.float32)
        slots = self._overflow0 + np.arange(len(pages))
        rows = stack if self._mode == "host" \
            else self.transfer.upload(stack)[0]
        self.write_stage(slots, rows)
        self.tail_writes += 1
        self.tail_staged += len(pages)
        return self.capacity + slots

    def _tail_room(self) -> int:
        if self.overflow_rows < 1:
            raise RuntimeError(
                "a compute call needs pages the slab does not hold and the "
                "pool has no overflow tail (overflow_rows=0)")
        return self.overflow_rows

    def _pieces(self, phys2d: np.ndarray, dev2d: np.ndarray, rbs):
        """Cut the block rows ``rbs`` (ascending) of a call into pieces
        whose missing pages each fit the overflow tail: ``(block rows,
        first column, end column, missing pages)``.  Whole block rows go
        together while they fit; a block row that alone does not is cut
        into column ranges."""
        l, cap = self.blocks_per_page, self._tail_room()
        gw = dev2d.shape[1]
        out, cur, cur_pages = [], [], set()
        for rb in rbs:
            pages = set((phys2d[rb][dev2d[rb] < 0] // l).tolist())
            if len(cur_pages | pages) <= cap:
                cur.append(rb)
                cur_pages |= pages
                continue
            if cur:
                out.append((cur, 0, gw, cur_pages))
            cur, cur_pages = [], set()
            if len(pages) <= cap:
                cur, cur_pages = [rb], pages
                continue
            j0, part = 0, set()
            for j in range(gw):
                p = {int(phys2d[rb, j]) // l} if dev2d[rb, j] < 0 else set()
                if len(part | p) > cap:
                    out.append(([rb], j0, j, part))
                    j0, part = j, set()
                part |= p
            out.append(([rb], j0, gw, part))
        if cur:
            out.append((cur, 0, gw, cur_pages))
        return out

    def _fill(self, dev2d, phys2d, rbs, j0: int, j1: int, pages):
        """Write ``pages`` into the overflow tail and return columns
        ``j0:j1`` of the map with the holes of block rows ``rbs``
        pointed there (int32; other rows keep their holes)."""
        m = dev2d[:, j0:j1].copy()
        if pages:
            l = self.blocks_per_page
            pages = np.array(sorted(pages), np.int64)
            rows = self._write_overflow(pages)
            sub, phys = m[rbs], phys2d[rbs, j0:j1]
            hole = sub < 0
            sub[hole] = rows[np.searchsorted(pages, phys[hole] // l)] * l \
                + phys[hole] % l
            m[rbs] = sub
        self.tail_chunks += 1
        return np.ascontiguousarray(m, np.int32)

    # ------------------------------------------------------------ compute --
    def _gather(self, bmap2d: np.ndarray, ids: np.ndarray, width: int):
        """The gather itself: rows ``ids`` through ``bmap2d`` [gh, gw'],
        ``width`` columns (an array in host mode, a tensor otherwise)."""
        bh, bw = self.block_shape
        gw = bmap2d.shape[1]
        if self._mode == "host":
            slab = self.host_slab
            flat_rows = slab.reshape(-1, bw)
            rb, off = ids // bh, ids % bh
            out = flat_rows[bmap2d[rb] * bh + off[:, None]]  # [n, gw, bw]
            return out.reshape(len(ids), gw * bw)[:, :width]
        ids_t = self._put(ids.astype(np.int32))
        bmap_t = self._put(bmap2d.astype(np.int32))
        kernel = ops if self._mode == "cuda" else ref
        return kernel.dedup_embedding_striped(ids_t, self.flat_pool(), bmap_t,
                                              width=width)

    def gather_rows(self, dev_map: np.ndarray, grid: BlockGrid,
                    rows: np.ndarray, pad: bool = False, block_map=None):
        """Rows of the virtual 2-D tensor, gathered from the resident
        slab.  cuda mode runs the ``dedup_embedding`` kernel (every
        column stripe in one launch); torch mode its plain version; host
        mode a numpy fancy-index gather from the slab mirror (returns
        np.ndarray).

        In the tensor modes ``rows`` is padded to a power-of-two bucket
        so downstream shapes stay stable; ``pad=True`` returns the padded
        ``[bucket, width]`` tensor (rows past ``n`` repeat a requested
        row) — indices into the first ``n`` rows are unaffected.

        A row whose block the map leaves a hole (-1: its page is not
        resident) is served through the overflow tail when the tensor's
        physical ``block_map`` is given, in groups of pages that each
        fit; without it the call returns None."""
        bh, bw = self.block_shape
        gh, gw = grid.grid
        width = grid.shape2d[1]
        rows = np.asarray(rows)      # repro: allow-host (index array)
        n = len(rows)
        bmap2d = dev_map.reshape(gh, gw)
        # Pad with a *requested* row, not row 0: under partial residency
        # row 0's block may be absent and must never be touched.
        ids = rows if self._mode == "host" else np.concatenate(
            [rows, np.full(_pad_pow2(max(n, 1)) - n,
                           rows[0] if n else 0, rows.dtype)])
        rbs = np.unique(ids // bh)
        staged = n and (bmap2d[rbs] < 0).any()
        if staged and block_map is None:
            return None
        if not staged:
            out = self._gather(bmap2d, ids, width)
        else:
            out = self._gather_staged(bmap2d, block_map.reshape(gh, gw),
                                      ids, rbs, width)
        return out if pad or self._mode == "host" else out[:n]

    def _gather_staged(self, dev2d, phys2d, ids, rbs, width: int):
        """:meth:`gather_rows` through the overflow tail, each missing
        page staged once: one gather of the resident blocks (a hole reads
        slab block 0, overwritten below), then the missing pages in
        groups the tail holds, each written there and gathered for the
        rows that read it, its blocks' stripes merged into the result."""
        bh, bw = self.block_shape
        l = self.blocks_per_page
        cap = self._tail_room()
        self.tail_calls += 1
        host = self._mode == "host"
        hole = dev2d < 0
        out = self._gather(np.where(hole, 0, dev2d), ids, width)
        self.tail_chunks += 1
        rb_of = ids // bh
        page_of = phys2d // l
        pages = np.unique(page_of[rbs][hole[rbs]])
        for c in range(0, len(pages), cap):
            group = pages[c:c + cap]
            rows = self._write_overflow(group)
            in_g = hole & np.isin(page_of, group)
            m = np.where(in_g, rows[np.searchsorted(
                group, np.where(in_g, page_of, group[0]))] * l
                + phys2d % l, np.where(hole, 0, dev2d))
            sel = np.flatnonzero(in_g[rb_of].any(axis=1))
            part = self._gather(m, ids[sel], width)
            self.tail_chunks += 1
            if host:
                cols = np.repeat(in_g[rb_of[sel]], bw, axis=1)[:, :width]
                out[sel] = np.where(cols, part, out[sel])
                continue
            sel_t = self._put(sel)
            cols = self._put(in_g)[self._put(rb_of[sel])] \
                .repeat_interleave(bw, dim=1)[:, :width]
            out.index_copy_(0, sel_t, torch.where(
                cols, part, out.index_select(0, sel_t)))
        return out

    def virtual_matmul(self, dev_map: np.ndarray, grid: BlockGrid, x,
                       block_map=None):
        """``x @ W_virtual`` with W never densified on the host: the
        ``dedup_matmul`` kernel streams slab blocks through the block map
        (cuda); torch mode runs its plain version against the slab; host
        mode runs the same k-loop blockwise in numpy against the mirror.

        A map with holes is served through the overflow tail when the
        physical ``block_map`` is given: K ranges whose missing pages
        each fit the tail, their products summed in fp32 (host mode
        keeps its k-loop order, so its sum is unchanged); without it the
        call returns None."""
        bh, bw = self.block_shape
        gh, gw = grid.grid
        K, N = grid.shape2d
        bmap2d = dev_map.reshape(gh, gw)
        staged = bool((bmap2d < 0).any())
        if staged and block_map is None:
            return None
        if staged:
            self.tail_calls += 1
            phys2d = block_map.reshape(gh, gw)
            pieces = self._pieces(phys2d, bmap2d, range(gh))
        else:
            pieces = [(range(gh), 0, gw, None)]
        mode = self._mode
        if mode == "host":
            blocks = self.host_slab.reshape(-1, bh, bw)
            # repro: allow-host — host-mode kernel: the mirror IS the tier
            x = np.asarray(x, dtype=np.float32)
            xp = x
            if x.shape[-1] != gh * bh:
                if x.shape[-1] != K:
                    raise ValueError(f"x has {x.shape[-1]} features, the "
                                     f"tensor has {K} rows")
                xp = np.zeros(x.shape[:-1] + (gh * bh,), np.float32)
                xp[..., :K] = x
            y = np.zeros(x.shape[:-1] + (gw * bw,), np.float32)
            for ks, j0, j1, pages in pieces:
                m = bmap2d if not staged else \
                    self._fill(bmap2d, phys2d, ks, j0, j1, pages)
                for j in range(j0, j1):          # the kernel's (j, k) loops
                    acc = y[..., j * bw:(j + 1) * bw]
                    for k in ks:
                        acc += xp[..., k * bh:(k + 1) * bh] \
                            @ blocks[m[k, j - j0]]
            return y[..., :N]
        x = torch.as_tensor(x, device=self.device)
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.to(self.dtype)
        pad = gh * bh - x.shape[-1]
        if pad:
            if x.shape[-1] != K:
                raise ValueError(f"x has {x.shape[-1]} features, the "
                                 f"tensor has {K} rows")
            x = torch.nn.functional.pad(x, (0, pad))
        if not staged:
            return self._matmul(x, bmap2d)[..., :N]
        y = torch.zeros(x.shape[:-1] + (gw * bw,), dtype=torch.float32,
                        device=self.device)
        for ks, j0, j1, pages in pieces:
            m = self._fill(bmap2d, phys2d, ks, j0, j1, pages)
            k0, k1 = ks[0], ks[-1] + 1
            y[..., j0 * bw:j1 * bw] += self._matmul(
                x[..., k0 * bh:k1 * bh], m[k0:k1]).float()
        return y.to(x.dtype)[..., :N]

    def _matmul(self, x: torch.Tensor, bmap2d: np.ndarray) -> torch.Tensor:
        """``x @`` the blocks of ``bmap2d`` (x's width is its rows x bh)."""
        bmap_t = self._put(bmap2d.astype(np.int32))
        if self._mode == "cuda":
            return ops.dedup_matmul(x.contiguous(), self.flat_pool(), bmap_t)
        return ref.dedup_matmul(x, self.flat_pool(), bmap_t)

    def unblock(self, dev_map: np.ndarray, grid: BlockGrid, block_map=None):
        """Full tensor reassembled from resident slab blocks (the LM
        model-switch path; np from the mirror in host mode, a tensor on
        the pool's device otherwise).  A map with holes is served through
        the overflow tail when the physical ``block_map`` is given: the
        missing pages in groups that each fit, their blocks gathered
        after each group's write; without it the call returns None."""
        hole = dev_map < 0
        staged = bool(hole.any())
        if staged and block_map is None:
            return None
        mode = self._mode
        gh, gw = grid.grid
        K, N = grid.shape2d
        if mode == "host":
            from ..core.blocks import unblock_tensor
            blocks = self._unblock_staged(dev_map, block_map, hole) \
                if staged else self._blocks(dev_map)
            return unblock_tensor(blocks, grid)
        if not staged:
            W = ref.materialize_virtual(
                self.flat_pool(), self._put(dev_map.reshape(gh, gw)),
                K, N)
        else:
            W = ref.materialize_virtual(
                self._unblock_staged(dev_map, block_map, hole),
                self._put(np.arange(gh * gw).reshape(gh, gw)), K, N)
        return W.reshape(grid.tensor_shape)

    def _blocks(self, idx: np.ndarray):
        """Slab blocks ``idx`` of the kernel view (the mirror's in host
        mode)."""
        if self._mode == "host":
            bh, bw = self.block_shape
            return self.host_slab.reshape(-1, bh, bw)[idx]
        return self.flat_pool()[self._put(idx)]

    def _unblock_staged(self, dev_map, phys, hole):
        """The blocks of ``dev_map`` in order: resident ones off the
        slab, the rest through the overflow tail a page group at a
        time."""
        cap = self._tail_room()
        l = self.blocks_per_page
        self.tail_calls += 1
        shape = (len(dev_map),) + self.block_shape
        host = self._mode == "host"
        blocks = np.empty(shape, np.float32) if host else torch.empty(
            shape, dtype=self.dtype, device=self.device)
        put = (lambda idx: idx) if host else self._put
        keep = np.flatnonzero(~hole)
        if len(keep):
            blocks[put(keep)] = self._blocks(dev_map[keep])
        miss = np.flatnonzero(hole)
        mpages = phys[miss] // l
        pages = np.unique(mpages)
        for c in range(0, len(pages), cap):
            group = pages[c:c + cap]
            rows = self._write_overflow(group)
            sel = miss[np.isin(mpages, group)]
            blocks[put(sel)] = self._blocks(
                rows[np.searchsorted(group, phys[sel] // l)] * l
                + phys[sel] % l)
            self.tail_chunks += 1
        return blocks
