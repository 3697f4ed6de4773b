"""Batched, overlapped host->device page transfers (DESIGN.md §6).

Counterpart of ``repro.serving.transfer``.  The per-page miss path pays
K serialized host->device round trips for a batch with K misses
(``DevicePagePool.load``).  The :class:`TransferEngine` is the grouped
alternative the buffer pool's ``on_load_group`` callback drives:

  * **coalesce** — a group's pages are assembled into ONE stacked host
    staging buffer (``ModelStore.page_stack``: a single grouped backend
    fault plus one vectorized gather, never K ``page_array`` calls);
  * **one transfer** — the stack ships with a single host->device copy
    and commits with a single ``index_copy_`` into the slab, so the slab
    is rewritten once per group, not once per page;
  * **one generation bump** — downstream remap caches are invalidated
    once per group instead of K times;
  * **double buffering** — :meth:`stage` lets the serving engine issue
    the *next* batch's transfer while the current batch computes.  On
    CUDA the stack is copied into pinned host memory and shipped on a
    side stream, with an event recorded after the copy; the commit
    makes the current stream wait on that event, so the bytes move
    under the in-flight compute.  Staged-ahead bytes are counted as
    *overlapped* (``ServeStats.overlap_fraction``).

Every movement — grouped or the pool's per-page fallback — is recorded
as a ``(pages, bytes, seconds)`` sample.  On CUDA the seconds are DEVICE
time between two events around the copy and the commit (a host clock
would only see the enqueue); the events are resolved lazily, in
:meth:`resolve`, which the server calls when it reads the counters.
:meth:`storage_model` fits ``seconds = seek + bytes / bandwidth`` over
a blocking :meth:`measure` sweep, so the host<->device channel of the
virtual clock is charged at the measured group-transfer bandwidth.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import get_tracer

__all__ = ["TransferStats", "PendingGroup", "TransferEngine",
           "fit_channel"]

#: samples kept for the bandwidth fit (serving runs are unbounded)
_MAX_RECORDS = 512
#: unresolved CUDA-event timings kept before a forced resolve
_MAX_TIMERS = 64


def _bucket_pad(*arrs: np.ndarray):
    """Pad index arrays (all the same length) to the next power of two
    by repeating their first element — duplicate gathers/writes of
    identical rows are harmless — so varying group sizes reuse a few
    index shapes instead of one per size."""
    n = len(arrs[0])
    bucket = 1
    while bucket < n:
        bucket <<= 1
    if bucket == n:
        return arrs if len(arrs) > 1 else arrs[0]
    out = tuple(np.concatenate([a, np.full(bucket - n, a[0], a.dtype)])
                for a in arrs)
    return out if len(out) > 1 else out[0]


@dataclasses.dataclass
class TransferStats:
    """Host->device movement counters for one TransferEngine."""
    groups: int = 0              # commit operations (a per-page load = 1)
    pages: int = 0               # pages moved host->device
    bytes: int = 0               # bytes moved host->device
    seconds: float = 0.0         # device seconds (CUDA events) on CUDA,
    #                              host seconds in the torch/host modes
    overlapped_bytes: int = 0    # bytes that were staged ahead of demand
    staged_groups: int = 0       # prestage() calls that issued a transfer
    records: List[Tuple[int, int, float]] = \
        dataclasses.field(default_factory=list)   # (pages, bytes, seconds)

    def record(self, pages: int, nbytes: int, seconds: float,
               overlapped_bytes: int = 0) -> Optional[int]:
        """Count one movement; returns its index in ``records`` (None
        once the sample buffer is full)."""
        self.groups += 1
        self.pages += pages
        self.bytes += nbytes
        self.seconds += seconds
        self.overlapped_bytes += overlapped_bytes
        if len(self.records) < _MAX_RECORDS:
            self.records.append((pages, nbytes, seconds))
            return len(self.records) - 1
        return None

    def settle(self, index: Optional[int], seconds: float) -> None:
        """Add the device seconds of a movement recorded with 0.0."""
        self.seconds += seconds
        if index is not None:
            pages, nbytes, _ = self.records[index]
            self.records[index] = (pages, nbytes, seconds)

    @property
    def overlap_fraction(self) -> float:
        return self.overlapped_bytes / self.bytes if self.bytes else 0.0


@dataclasses.dataclass
class PendingGroup:
    """A staged (not yet committed) transfer: host stack assembled and,
    on a device slab, the device copy already issued."""
    index: Dict[int, int]                # pid -> row in the stack
    host: np.ndarray                     # [k, l, bh, bw] staging buffer
    dev: Optional[torch.Tensor]          # device copy (None in host mode)
    pack_generation: int
    pinned: Optional[torch.Tensor] = None    # pinned source of the copy
    ready: Optional[object] = None           # torch.cuda.Event after it


def fit_channel(records: Sequence[Tuple[int, int, float]]
                ) -> Tuple[float, float]:
    """Least-squares ``seconds = seek + bytes/bandwidth`` over measured
    group samples; returns ``(bandwidth B/s, seek seconds)`` clamped to
    sane ranges (degenerate sample sets fall back to mean throughput)."""
    recs = [(b, t) for _, b, t in records if t > 0 and b > 0]
    if not recs:
        return 20e9, 1e-6                      # dram-ish: nothing measured
    xs = np.array([b for b, _ in recs], np.float64)
    ys = np.array([t for _, t in recs], np.float64)
    if len(recs) >= 2 and np.ptp(xs) > 0:
        slope, seek = np.polyfit(xs, ys, 1)
        if slope <= 0:
            # flat (or noise-inverted) size axis: the channel is per-
            # OPERATION dominated — model it as pure seek, free bytes
            return 1e13, float(np.mean(ys))
        seek = max(seek, 0.0)
    else:
        slope, seek = float(np.mean(ys / xs)), 0.0
    bandwidth = float(np.clip(1.0 / max(slope, 1e-15), 1e6, 1e14))
    return bandwidth, float(max(seek, 0.0))


class TransferEngine:
    """Grouped page movement for one :class:`~repro_torch.serving.
    device_pool.DevicePagePool`.  The pool owns residency bookkeeping
    (slots, generation); this class owns how bytes get there."""

    def __init__(self, pool, max_pending: int = 2):
        self.pool = pool
        self.max_pending = max_pending
        self.stats = TransferStats()
        self._pending: "OrderedDict[frozenset, PendingGroup]" = OrderedDict()
        self._copy_stream = None             # side CUDA stream of stage()
        # CUDA mode: (record index, start event, end event) not yet read
        self._timers: List[Tuple[Optional[int], object, object]] = []

    # ------------------------------------------------------------ helpers --
    @property
    def page_nbytes(self) -> int:
        bh, bw = self.pool.block_shape
        return self.pool.blocks_per_page * bh * bw \
            * np.dtype(np.float32).itemsize

    def _cuda(self) -> bool:
        return self.pool.mode() == "cuda"

    def _missing(self, pids) -> List[int]:
        seen, out = set(), []
        for p in pids:
            p = int(p)
            if p not in seen and p not in self.pool.slot_of:
                seen.add(p)
                out.append(p)
        return out

    # Callers (load_group / stage) own the channel charge; _stack
    # only assembles bytes.  # repro: allow-uncharged
    def _stack(self, pids: List[int]) -> np.ndarray:
        """One grouped backend fault + one vectorized gather."""
        return self.pool.store.page_stack(pids, dtype=np.float32)

    def host_tensor(self, stack: np.ndarray) -> torch.Tensor:
        """The host side of an upload: the stack as a float32 CPU tensor,
        in pinned memory on CUDA so the copy can be asynchronous."""
        src = torch.from_numpy(np.ascontiguousarray(stack, np.float32))
        if not self._cuda():
            return src
        pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
        pinned.copy_(src)
        return pinned

    def device_buffer(self, shape) -> torch.Tensor:
        """An uninitialised slab-dtype tensor on the pool's device."""
        return torch.empty(tuple(shape), dtype=self.pool.dtype,
                           device=self.pool.device)

    def ship(self, host: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The device side of an upload: enqueue the copy of a
        :meth:`host_tensor` into ``out`` (a :meth:`device_buffer`, made
        here when not given) on the current stream.  Keep ``host`` alive
        until the copy is done."""
        if out is None:
            out = self.device_buffer(host.shape)
        out.copy_(host, non_blocking=self._cuda())
        return out

    def upload(self, stack: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(device tensor, host source)`` of a host stack."""
        host = self.host_tensor(stack)
        return self.ship(host), host

    def warm(self) -> None:
        """Run the commit path once on one scratch page (CUDA mode).  The
        first use of each kernel loads its module lazily — 0.14 s for
        the staged commit's ``index_select`` on the H100 — and that
        host stall would otherwise land inside the first timed commit
        and hold up the first batch that meets it."""
        page = self.host_tensor(np.zeros(
            (1,) + tuple(self.pool.slab.shape[1:]), np.float32))
        idx = self._index(np.zeros(1))
        dev = self.ship(page)
        scratch = self.device_buffer(dev.shape)
        torch.index_select(dev, 0, idx, out=scratch)
        scratch.index_copy_(0, idx, dev)
        torch.cuda.synchronize(self.pool.device)

    def _index(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(arr, np.int64)).to(self.pool.device)

    def drop_pending(self) -> None:
        self._pending.clear()

    def _fresh_pending(self) -> None:
        """Evict stale (repacked) and over-quota pending stages."""
        gen = self.pool.store.pack_generation
        for key in [k for k, pg in self._pending.items()
                    if pg.pack_generation != gen]:
            del self._pending[key]
        while len(self._pending) > self.max_pending:
            self._pending.popitem(last=False)

    # ------------------------------------------------------------- timing --
    def start_timer(self):
        """Start timing a host->device leg: a CUDA event recorded on the
        current stream in CUDA mode (record it right before the device
        work is enqueued, so host-side preparation stays out), the host
        clock otherwise."""
        if not self._cuda():
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.pool.device))
        return ev

    def stop_timer(self, start, pages: int, overlapped_bytes: int = 0) -> None:
        """Count ``pages`` moved since :meth:`start_timer`.  CUDA timings
        are device time, read later by :meth:`resolve`."""
        nbytes = pages * self.page_nbytes
        if isinstance(start, float):
            self.stats.record(pages, nbytes, time.perf_counter() - start,
                              overlapped_bytes=overlapped_bytes)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.pool.device))
        idx = self.stats.record(pages, nbytes, 0.0,
                                overlapped_bytes=overlapped_bytes)
        self._timers.append((idx, start, end))
        if len(self._timers) > _MAX_TIMERS:
            self.resolve()

    def resolve(self) -> None:
        """Fold finished CUDA-event timings into the stats (waits for
        the events; a no-op off CUDA)."""
        for idx, start, end in self._timers:
            end.synchronize()
            self.stats.settle(idx, start.elapsed_time(end) * 1e-3)
        self._timers.clear()

    # ------------------------------------------------------------ staging --
    def _side_stream(self):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.pool.device)
        return self._copy_stream

    def stage(self, pids) -> Optional[PendingGroup]:
        """Assemble ``pids``'s not-yet-resident pages into one staging
        stack and issue the device copy.  The engines call this for the
        *next* batch right before computing the current one, so on CUDA
        the copy runs on a side stream under compute.  Commit happens
        later, when the buffer pool actually admits the pages
        (:meth:`load_group`)."""
        self.pool.store.packing                  # settle before gen read
        self._fresh_pending()
        missing = self._missing(pids)
        if not missing:
            return None
        key = frozenset(missing)
        hit = self._pending.get(key)
        if hit is not None:
            return hit
        for staged in self._pending.values():    # already covered by one?
            if key <= staged.index.keys():
                return staged
        dev = pinned = ready = None
        with get_tracer().span("stage", kind="transfer",
                               pages=len(missing),
                               bytes=len(missing) * self.page_nbytes):
            stack = self._stack(missing)
            if self._cuda():
                # the copy and its destination belong to the side stream;
                # the consumer records its own use at commit
                side = self._side_stream()
                with torch.cuda.stream(side):
                    dev, pinned = self.upload(stack)
                    ready = torch.cuda.Event()
                    ready.record(side)
            elif self.pool.mode() != "host":
                dev, _ = self.upload(stack)
        pg = PendingGroup({p: i for i, p in enumerate(missing)}, stack, dev,
                          self.pool.store.pack_generation, pinned, ready)
        self._pending[key] = pg
        while len(self._pending) > self.max_pending:
            self._pending.popitem(last=False)
        self.stats.staged_groups += 1
        return pg

    # ------------------------------------------------------------- commit --
    def _full_cover(self, missing: List[int]) -> Optional[PendingGroup]:
        """A pending group whose staged bytes cover the WHOLE commit
        (the double-buffer hit).  Partial covers are not spliced; a
        clean restage is cheaper and rarer."""
        key = set(missing)
        for pg in self._pending.values():
            if key <= pg.index.keys():
                return pg
        return None

    def _commit_staged(self, pg: PendingGroup, rows: np.ndarray,
                       slots: np.ndarray):
        """Gather the staged rows on the device and write them into the
        slab; on CUDA the current stream first waits for the copy.
        Returns the CUDA timer started after that wait (None off CUDA):
        the overlapped copy itself is not the commit's cost."""
        rows_p, slots_p = _bucket_pad(rows, slots)
        rows_t, slots_t = self._index(rows_p), self._index(slots_p)
        staged = self.device_buffer((len(rows_p),) + tuple(pg.dev.shape[1:]))
        timer = None
        if pg.ready is not None:
            cur = torch.cuda.current_stream(self.pool.device)
            cur.wait_event(pg.ready)
            pg.dev.record_stream(cur)        # read here, allocated on side
            timer = self.start_timer()
        torch.index_select(pg.dev, 0, rows_t, out=staged)
        self.pool.slab.index_copy_(0, slots_t, staged)
        return timer

    def load_group(self, pids) -> int:
        """Commit a group: one ``index_copy_`` into the slab (one write
        into the host mirror in host mode), one generation bump.  A
        group fully staged by a previous :meth:`stage` commits from the
        already in-flight device bytes (the overlapped path, counted in
        ``overlapped_bytes``); anything else is staged now.  Returns
        pages loaded."""
        self._fresh_pending()
        missing = self._missing(pids)
        if not missing:
            return 0
        if len(missing) > len(self.pool._free):
            raise RuntimeError(
                f"group of {len(missing)} pages exceeds the slab's "
                f"{len(self.pool._free)} free slots")
        with get_tracer().span("load_group", kind="transfer",
                               pages=len(missing),
                               bytes=len(missing) * self.page_nbytes) as sp:
            pg = self._full_cover(missing)
            overlapped = 0
            if pg is not None:
                rows = np.asarray([pg.index[p] for p in missing],
                                  dtype=np.int64)
                # the host rows are needed only where no device copy is
                # in flight (host mode)
                host_stack = pg.host[rows] if pg.dev is None else None
                # staged ahead of demand: on a device slab the bytes are
                # already in flight; in host mode the staging stack (the
                # grouped store gather) was assembled under compute
                overlapped = len(missing) * self.page_nbytes
                for key in [k for k, v in self._pending.items() if v is pg]:
                    del self._pending[key]       # consumed
            else:
                rows = None
                host_stack = self._stack(missing)
            # Time only the host->device leg (copy + commit, or the
            # mirror write in host mode; on CUDA the device work alone):
            # _stack() above may fault the STORAGE backend, and a channel
            # fitted over storage seconds would double-charge misses
            # under charge_transfer.
            start = None if self._cuda() else self.start_timer()
            slots = np.asarray([self.pool._free.pop() for _ in missing],
                               dtype=np.int64)
            # Exception safety: slots are popped, but residency maps are
            # not yet touched.  If the device leg fails, every popped slot
            # goes back to the free list and the generation is NOT bumped
            # — the pool looks exactly as before the call (no half-mapped
            # slots; slab bytes in an unmapped slot are unreachable by any
            # remap).
            try:
                if self.pool.mode() == "host":
                    # repro: allow-slab-write (the transfer layer owns slab writes)
                    self.pool.host_slab[slots] = host_stack
                elif pg is not None and pg.dev is not None:
                    timer = self._commit_staged(pg, rows, slots)
                    start = start if timer is None else timer
                else:
                    # everything allocated before the timer starts: only
                    # device work lies between its two events
                    host = self.host_tensor(host_stack)
                    slots_t = self._index(slots)
                    buf = self.device_buffer(host.shape)
                    if self._cuda():
                        start = self.start_timer()
                    self.pool.slab.index_copy_(0, slots_t,
                                               self.ship(host, buf))
            except BaseException:
                self.pool._free.extend(int(s) for s in slots)
                raise

            for pid, slot in zip(missing, slots):
                self.pool.slot_of[pid] = int(slot)
                self.pool._page_to_slot[pid] = int(slot)
            self.pool.generation += 1            # ONCE per group
            self.pool.loads += len(missing)
            self.stop_timer(start, len(missing), overlapped_bytes=overlapped)
            sp.set(overlapped_bytes=overlapped)
        return len(missing)

    # -------------------------------------------------------- calibration --
    def measure(self, group_sizes: Sequence[int] = (1, 2, 4, 8),
                reps: int = 3) -> List[Tuple[int, int, float]]:
        """Blocking bandwidth sweep: time a size-n upload + commit into a
        scratch buffer of n pages (the same work per page as a real
        commit) for each group size, without touching residency.  CUDA
        times are device time from events.  Returns ``(pages, bytes,
        best seconds)`` samples."""
        bh, bw = self.pool.block_shape
        l = self.pool.blocks_per_page
        out: List[Tuple[int, int, float]] = []
        rng = np.random.default_rng(0)
        for n in group_sizes:
            n = int(min(n, max(1, self.pool.capacity)))
            src = rng.standard_normal((n, l, bh, bw)).astype(np.float32)
            best = float("inf")
            # one untimed warmup per size so allocator effects never
            # pollute the fit
            for rep in range(max(1, reps) + 1):
                if self.pool.mode() == "host":
                    # host tier: the "transfer" is a mirror memcpy
                    t0 = time.perf_counter()
                    scratch = np.empty_like(src)
                    scratch[:] = src
                    dt = time.perf_counter() - t0
                else:
                    dt = self._timed_commit(src)
                if rep:
                    best = min(best, dt)
            out.append((n, n * self.page_nbytes, best))
        return out

    def _timed_commit(self, src: np.ndarray) -> float:
        n = src.shape[0]
        scratch = torch.empty(src.shape, dtype=self.pool.dtype,
                              device=self.pool.device)
        slots = self._index(np.arange(n))
        if not self._cuda():
            t0 = time.perf_counter()
            scratch.index_copy_(0, slots, self.ship(self.host_tensor(src)))
            return time.perf_counter() - t0
        host = self.host_tensor(src)
        buf = self.device_buffer(src.shape)
        stream = torch.cuda.current_stream(self.pool.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        scratch.index_copy_(0, slots, self.ship(host, buf))
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    def storage_model(self, group_sizes: Sequence[int] = (1, 2, 4, 8),
                      reps: int = 3, **kw):
        """A :class:`~repro_torch.serving.engine.StorageModel` of the
        host<->device channel, fitted from a BLOCKING :meth:`measure`
        sweep — the calibrated replacement for preset per-page
        charges."""
        self.resolve()
        bandwidth, seek = fit_channel(self.measure(group_sizes, reps))
        from .engine import StorageModel
        kw.setdefault("channel", "hbm")
        return StorageModel(kind=f"measured:{self.pool.mode()}",
                            bandwidth=bandwidth, seek=seek, **kw)
