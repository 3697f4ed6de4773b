"""Multi-model serving engine backed by the deduplicated page store.

Counterpart of ``repro.serving.engine`` for PyTorch on a GPU.  This is
the paper's runtime loop transposed to the GPU memory hierarchy
(DESIGN.md §2): the **page store** (host DRAM / checkpoint) holds the
deduplicated pages; the **buffer pool** decides which pages are
device-resident (HBM); inference touches pages through the pool, so
shared pages hit for *every* model variant that uses them.

Components:
  * :class:`StorageModel` — virtual-clock latency model for the backing
    tier (ssd / hdd / nvme / host-dram), used when a page misses.  Group
    fetches amortize the seek across a batch's misses.
  * :class:`FetchComputeTimeline` — double-buffered virtual clock: batch
    t's group fetch occupies the storage channel while batch t-1 still
    computes, so Eq. 1/Eq. 2 hit-ratio wins translate into latency wins.
  * :class:`WeightServer` — ModelStore + BufferPool + storage sim; tracks
    per-model arrival rates (the lambda_i of Eq. 2 flow straight into the
    pool's eviction policy).  Optional hedged fetches for stragglers.
    ``backend="device"`` (the default) attaches a :class:`~repro_torch.
    serving.device_pool.DevicePagePool`: buffer-pool loads/evicts become
    real host->HBM page transfers into a preallocated slab, and the
    engines compute through the CUDA dedup kernels against the resident
    slab instead of re-densifying weights in numpy (DESIGN.md §3).
  * :class:`EmbeddingServingEngine` — the paper's word2vec / text-
    classification scenario, now scheduler-driven: batch order is a
    policy (fifo / round_robin / dedup_affinity, see
    ``serving/scheduler.py``), and an optional λ-driven
    :class:`~repro_torch.serving.prefetch.Prefetcher` pulls hot models'
    pages ahead of demand.

  * :class:`LMServingEngine` — LM variants served with batched prefill
    and decode; a model switch faults the variant's page working set into
    the device slab and reassembles every tensor on the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.bufferpool import BufferPool
from ..core.store import ModelStore
from ..obs import get_tracer
from ..storage.faults import StorageFaultError
from .scheduler import BatchScheduler, ScheduledBatch, make_scheduler

# ------------------------------------------------------------------ storage --
STORAGE_PRESETS = {
    # (bandwidth B/s, seek seconds)
    "hdd": (150e6, 8e-3),
    "ssd": (500e6, 1e-4),
    "nvme": (3e9, 2e-5),
    "dram": (20e9, 1e-6),
}


@dataclasses.dataclass
class StorageModel:
    """Virtual-clock latency model of the page-backing tier.

    Either a named preset (``kind`` in :data:`STORAGE_PRESETS`) or
    explicit ``bandwidth``/``seek`` parameters — typically calibrated
    from a live backend's :meth:`~repro_torch.storage.PageBackend.microbench`
    via :meth:`from_backend`, so misses are charged what the tier
    actually costs instead of a hardcoded hdd/ssd/nvme guess.
    """
    kind: str = "ssd"
    hedge_after: Optional[float] = None    # straggler hedging deadline (s)
    jitter: float = 0.0                    # lognormal sigma for tail latency
    seed: int = 0
    bandwidth: Optional[float] = None      # B/s override (calibrated)
    seek: Optional[float] = None           # seconds override (calibrated)
    channel: str = "storage"               # named virtual-clock channel

    def __post_init__(self):
        if self.bandwidth is None or self.seek is None:
            try:
                bw, seek = STORAGE_PRESETS[self.kind]
            except KeyError:
                raise ValueError(
                    f"unknown storage kind {self.kind!r} and no explicit "
                    f"bandwidth/seek given; presets: "
                    f"{sorted(STORAGE_PRESETS)}") from None
            self.bandwidth = bw if self.bandwidth is None else self.bandwidth
            self.seek = seek if self.seek is None else self.seek
        self.bw = self.bandwidth
        self._rng = np.random.default_rng(self.seed)

    @classmethod
    def from_backend(cls, backend, page_bytes: int = 128 * 1024,
                     **kw) -> "StorageModel":
        """Calibrate from a backend microbenchmark: the returned model
        charges misses with the measured (seek, bandwidth) of the tier
        the pages actually live in."""
        prof = backend.microbench(page_bytes=page_bytes)
        return cls(kind=f"calibrated:{prof.backend}",
                   bandwidth=prof.bandwidth, seek=prof.seek, **kw)

    def _draw(self, base: float) -> float:
        if self.jitter:
            draw = base * float(self._rng.lognormal(0.0, self.jitter))
            if self.hedge_after is not None and draw > self.hedge_after:
                # hedged duplicate fetch: take min of two draws
                draw = min(draw,
                           self.hedge_after
                           + base * float(self._rng.lognormal(0.0,
                                                              self.jitter)))
            return draw
        return base

    def fetch_seconds(self, nbytes: int) -> float:
        return self._draw(self.seek + nbytes / self.bw)

    def fetch_group_seconds(self, nbytes: int, n: int) -> float:
        """Virtual time for ``n`` pages issued as ONE grouped request:
        a single seek plus pipelined transfers (the scheduler issues a
        batch's misses together instead of page-at-a-time)."""
        if n <= 0:
            return 0.0
        return self._draw(self.seek + n * nbytes / self.bw)

    def transfer_seconds(self, nbytes: int) -> float:
        """One seek-less pipelined transfer (a follow-on page inside an
        already-open group); jitter/hedging apply per transfer."""
        return self._draw(nbytes / self.bw)


@dataclasses.dataclass
class FetchComputeTimeline:
    """Two-channel virtual clock.  The fetch channel serializes storage
    traffic (demand groups + prefetches); a batch's compute starts once
    both its fetch group completed and the previous compute finished —
    i.e. fetch(t) overlaps compute(t-1), the classic double buffer."""
    fetch_clock: float = 0.0
    compute_clock: float = 0.0

    def advance(self, fetch_t: float, compute_t: float
                ) -> Tuple[float, float]:
        """Account one batch; returns (issue_time, completion_time)."""
        issue = self.fetch_clock
        self.fetch_clock += fetch_t
        start_compute = max(self.fetch_clock, self.compute_clock)
        self.compute_clock = start_compute + compute_t
        return issue, self.compute_clock

    def charge_fetch(self, seconds: float) -> None:
        """Occupy the fetch channel without a compute phase (prefetch)."""
        self.fetch_clock += seconds

    @property
    def makespan(self) -> float:
        return max(self.fetch_clock, self.compute_clock)


@dataclasses.dataclass
class ServeStats:
    """Per-engine serving counters (virtual fetch seconds, wall
    compute seconds, transfer/overlap/borrow accounting)."""
    requests: int = 0
    batches: int = 0
    fetch_seconds: float = 0.0       # virtual storage time (demand)
    compute_seconds: float = 0.0     # wall compute time
    prefetch_seconds: float = 0.0    # virtual storage time (speculative)
    pages_fetched: int = 0
    prefetch_pages: int = 0
    timeline_seconds: float = 0.0    # double-buffered makespan (async runs)
    overlapped: bool = False         # engine ran with overlap=True
    device_batches: int = 0          # batches computed against the HBM slab
    dense_fallbacks: int = 0         # device batches that fell back to host
    # -- host->HBM transfer engine (serving/transfer.py) --
    transfer_seconds: float = 0.0    # seconds moving pages host->HBM:
    #                                  device time (CUDA events) on a GPU
    transfer_pages: int = 0          # pages moved
    transfer_groups: int = 0         # physical transfer operations issued
    transfer_bytes: int = 0          # bytes moved
    transfer_overlapped_bytes: int = 0   # of those: staged under compute
    group_sizes: List[float] = dataclasses.field(default_factory=list)
    # ^ per batch: pages moved / transfer ops (1.0 = per-page path)
    # -- sharded serving (serving/shard_pool.py) --
    borrow_pages: int = 0            # minority pages staged cross-shard
    borrow_seconds: float = 0.0      # virtual fetch-channel time on borrows
    borrow_mirror_hits: int = 0      # borrows served from an owner's mirror
    borrow_store_faults: int = 0     # borrows that first faulted the owner
    borrow_coalesced: int = 0        # borrows reused from a prior batch's
    #                                  staging (consecutive-batch coalescing)
    shard_batches: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- fault recovery (storage/faults.py, DESIGN.md §8) --
    retries: int = 0                 # transient backend errors retried
    corrupt_detected: int = 0        # pages failing sha256 verification
    refetch_pages: int = 0           # quarantined pages re-fetched grouped
    failovers: int = 0               # shards failed over mid-run
    degraded_batches: int = 0        # batches that degraded to the host
    #                                  path after a device-path fault
    fault_backoff_seconds: float = 0.0   # virtual clock: retry backoff +
    #                                      injected latency (its own named
    #                                      channel so BENCH stays honest)
    latencies: List[float] = dataclasses.field(default_factory=list)
    # per-batch virtual fetch-channel seconds (storage + interconnect):
    # deterministic, so placement policies compare free of wall noise
    fetch_latencies: List[float] = dataclasses.field(default_factory=list)
    # -- request-level serving (serving/frontend.py) --
    offered_requests: int = 0        # arrivals presented to the frontend
    shed_requests: int = 0           # admission-shed (never served)
    slo_misses: int = 0              # served, but past their deadline
    queue_latencies: List[float] = dataclasses.field(default_factory=list)
    # ^ per served request: arrival -> dispatch (virtual seconds)
    service_latencies: List[float] = dataclasses.field(default_factory=list)
    # ^ per served request: dispatch -> done (its batch's service time)
    request_latencies: List[float] = dataclasses.field(default_factory=list)
    # ^ per served request: arrival -> done (queue + service)
    readmitted_requests: int = 0     # re-queued by a warm restart
    # ^ queued + in-flight ids a ServingFrontend.restore put back
    #   (DESIGN.md §11): at-most-once delivery, deterministic recompute

    @property
    def total_seconds(self) -> float:
        """Serial cost: every storage second plus every compute second."""
        return self.fetch_seconds + self.prefetch_seconds \
            + self.compute_seconds

    @property
    def makespan_seconds(self) -> float:
        """End-to-end virtual time: the overlapped timeline when the
        engine ran async, the serial sum otherwise.  An overlapped run
        whose timeline never advanced is a bug in the engine loop — it
        must never be papered over with the serial sum."""
        if self.overlapped:
            if self.batches and self.timeline_seconds <= 0.0:
                raise RuntimeError(
                    "overlap=True but the fetch/compute timeline never "
                    "advanced; refusing to report the serial sum as an "
                    "overlapped makespan")
            return self.timeline_seconds
        return self.total_seconds

    @property
    def overlap_fraction(self) -> float:
        """Fraction of host->HBM bytes whose transfer was staged ahead
        of demand (issued under the previous batch's compute — the
        double-buffered path)."""
        return self.transfer_overlapped_bytes / self.transfer_bytes \
            if self.transfer_bytes else 0.0

    @property
    def mean_group_size(self) -> float:
        return float(np.mean(self.group_sizes)) if self.group_sizes else 0.0

    @property
    def goodput(self) -> float:
        """Fraction of *offered* requests served within their SLO
        (sheds and deadline misses both count against it); 0.0 before
        any request-level traffic has been offered."""
        if not self.offered_requests:
            return 0.0
        ok = len(self.request_latencies) - self.slo_misses
        return ok / self.offered_requests

    def percentile(self, p: float) -> float:
        """p-th percentile of per-batch latencies.  Raises
        ``ValueError`` when no batch has been served yet — a silent
        0.0 reads as an impossibly fast tail in reports; callers that
        want a default must guard explicitly."""
        if not self.latencies:
            raise ValueError(
                "percentile() on an empty latency list (no batches "
                "served); guard on stats.latencies for a default")
        return float(np.percentile(self.latencies, p))

    def request_percentile(self, p: float) -> float:
        """p-th percentile of per-request total latencies (frontend
        traffic); raises ``ValueError`` when no request was served."""
        if not self.request_latencies:
            raise ValueError(
                "request_percentile() on an empty request-latency list "
                "(no frontend traffic served); guard on "
                "stats.request_latencies for a default")
        return float(np.percentile(self.request_latencies, p))

    def register_into(self, registry, namespace: str = "serve") -> None:
        """Register every field as a live view in a
        :class:`~repro_torch.obs.metrics.MetricsRegistry` (numbers become
        counters, lists histograms, dicts gauges).  Views read the
        dataclass attributes directly, so the existing attribute API
        stays the single source of truth."""
        registry.register_object(
            namespace, self, [f.name for f in dataclasses.fields(self)])


# ------------------------------------------------------------- weight serve --
class WeightServer:
    """Page-granular weight access through the dedup-aware buffer pool.

    ``backend="device"`` (default) attaches a :class:`DevicePagePool`:
    every pool load/evict moves a real page into/out of a preallocated
    device slab, and the ``device_*`` accessors compute through
    the dedup kernels against that slab.  ``kernel_mode`` is forwarded
    to the device pool ("auto" = "cuda", the hand-written kernels, and
    raises without a CUDA device of capability (9, 0); "torch" the plain
    PyTorch versions; "host" numpy gathers from the slab's host mirror.
    See DevicePagePool's docstring).  In cuda mode a batch the slab
    cannot serve raises (:meth:`host_fallback_allowed`).  ``device``
    places the slab (the CUDA device in cuda mode; the CPU by default in
    torch mode, where a CUDA device runs the plain versions on the card).
    ``backend="numpy"`` is how a caller chooses the host simulator: the
    pool is a policy simulator and weights are materialized on the host.
    """

    TRANSFERS = ("per_page", "grouped")

    def __init__(self, store: ModelStore, capacity_pages: int,
                 policy: str = "optimized_mru",
                 storage: Optional[StorageModel] = None,
                 backend: str = "device", kernel_mode: str = "auto",
                 transfer: str = "grouped",
                 charge_transfer: bool = False,
                 hbm: Optional[StorageModel] = None,
                 device=None):
        if backend not in ("numpy", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if transfer not in self.TRANSFERS:
            raise ValueError(f"unknown transfer mode {transfer!r}; "
                             f"have {self.TRANSFERS}")
        self.store = store
        self.backend = backend
        self.transfer = transfer
        self.device_pool = None
        on_load = on_evict = on_load_group = None
        if backend == "device":
            from .device_pool import DevicePagePool
            self.device_pool = DevicePagePool(store, capacity_pages,
                                              kernel_mode=kernel_mode,
                                              device=device)
            on_load = self.device_pool.load
            on_evict = self.device_pool.evict
            if transfer == "grouped":
                on_load_group = self.device_pool.load_group
        self.pool: BufferPool = store.make_buffer_pool(
            capacity_pages, policy, on_load=on_load, on_evict=on_evict,
            on_load_group=on_load_group)
        self.storage = storage or StorageModel("ssd", channel="storage")
        # Host<->HBM channel of the virtual clock.  When ``charge_
        # transfer`` is set, misses additionally pay this channel —
        # per-page seeks on the per_page path, one seek per group on the
        # grouped path — calibrated lazily from the transfer engine's
        # *measured* bandwidth unless an explicit model is given.
        self.charge_transfer = charge_transfer
        self.hbm_channel = hbm
        bh, bw = store.cfg.dedup.block_shape
        # a page's cost on the wire is its *persisted* size (fp16 stores
        # move half the bytes of fp32 ones)
        self.page_bytes = store.cfg.blocks_per_page * bh * bw \
            * store.native_page_dtype().itemsize
        self.stats = ServeStats()
        self._pool_arr: Optional[np.ndarray] = None
        self._pool_gen = store.pack_generation   # make_buffer_pool packed
        self._fault_snap = store.fault_stats.snapshot()

    def _sync_store(self) -> None:
        """Detect a repack (model registered/updated/removed since the
        last access) and drop every stale consumer: the cached host pool
        array, the pool's resident set and the device slab all refer to
        page ids from the previous packing."""
        self.store.packing                       # force repack if stale
        if self._pool_gen == self.store.pack_generation:
            return
        self.pool.invalidate_resident()          # fires on_evict -> slab
        if self.device_pool is not None:
            self.device_pool.flush()
        sharers, locality = self.store.page_metadata()
        self.pool.page_sharers = sharers
        self.pool.page_locality = locality
        self.pool.meta.clear()                   # per-page meta is stale too
        self._pool_arr = None
        self._pool_gen = self.store.pack_generation

    def _pages(self) -> np.ndarray:
        self._sync_store()
        if self._pool_arr is None:
            self._pool_arr = self.store.page_pool()
        return self._pool_arr

    def host_fallback_allowed(self) -> bool:
        """Whether a device-backend batch may be computed on the host
        when the slab cannot serve it.  Only the CPU kernel modes keep
        the reference's fallback; in cuda mode the slab is on the card
        and a batch the slab cannot serve is an error, never a silent
        move of the work to the CPU."""
        return self.device_pool is None or self.device_pool.mode() != "cuda"

    def _access(self, model: str, page_ids) -> List[bool]:
        """Device backend touches a batch's pages as a pinned group so
        same-batch misses cannot tear the slab-resident working set; a
        group too large for the pool raises in cuda mode and falls back
        to unpinned access in the CPU modes (the compute path then falls
        back to the host)."""
        if self.backend == "device":
            try:
                return self.pool.access_group(model, page_ids)
            except ValueError:
                if not self.host_fallback_allowed():
                    raise
                # group exceeds the pool: unpinned per-page access, the
                # compute path will fall back to the host
                return [self.pool.access(model, pid) for pid in page_ids]
        return [self.pool.access(model, pid) for pid in page_ids]

    def _charge_faults(self) -> float:
        """Fold the store recovery layer's work since the last fold into
        the stats; returns the virtual seconds it cost (retry backoff +
        injected latency — the ``fault`` channel of the clock, kept
        distinct from storage fetch time so BENCH numbers stay honest).
        A cursor snapshot makes each recovery event count exactly once
        no matter which access or compute path triggered it."""
        d = self.store.fault_stats.since(self._fault_snap)
        self._fault_snap = self.store.fault_stats.snapshot()
        self.stats.retries += d.retries
        self.stats.corrupt_detected += d.corrupt_detected
        self.stats.refetch_pages += d.refetch_pages
        t = d.backoff_seconds + d.latency_seconds
        self.stats.fault_backoff_seconds += t
        return t

    def _hbm(self) -> StorageModel:
        """The host<->HBM channel model, calibrated on first use from
        the transfer engine's measured group-transfer bandwidth."""
        if self.hbm_channel is None:
            if self.device_pool is not None:
                self.hbm_channel = self.device_pool.transfer.storage_model()
            else:
                self.hbm_channel = StorageModel("dram", channel="hbm")
        return self.hbm_channel

    def _charge_hbm(self, misses: int) -> float:
        """Virtual host->HBM seconds for ``misses`` pages, per the
        server's transfer mode: the per_page path pays a seek per page,
        the grouped path one seek for the whole group."""
        if not self.charge_transfer or not misses \
                or self.backend != "device":
            return 0.0
        hbm = self._hbm()
        if self.transfer == "grouped":
            return hbm.fetch_group_seconds(self.page_bytes, misses)
        # drawn per page (not misses * one draw) so a jittered channel
        # tails properly — each per-page transfer is its own sample
        return float(sum(hbm.fetch_seconds(self.page_bytes)
                         for _ in range(misses)))

    def access_pages(self, model: str, page_ids) -> float:
        """Touch pages through the pool one at a time (serial baseline:
        every miss pays its own seek, inline); returns virtual seconds."""
        self._sync_store()
        page_ids = list(page_ids)
        t = 0.0
        misses = 0
        for hit in self._access(model, page_ids):
            if not hit:
                t += self.storage.fetch_seconds(self.page_bytes)
                misses += 1
                self.stats.pages_fetched += 1
        t += self._charge_hbm(misses)
        t += self._charge_faults()
        self.stats.fetch_seconds += t
        return t

    def access_pages_grouped(self, model: str, page_ids) -> float:
        """Touch pages through the pool, issuing all misses as ONE group
        fetch (single seek, pipelined transfer) — the async scheduler's
        per-batch demand fetch.  Returns the group's virtual seconds.

        On a backend-attached store the group's not-yet-resident pages
        are faulted out of the backend in one grouped ``get_pages`` call
        *before* the pool access, so every per-page ``on_load`` (e.g. a
        device-slab transfer) hits host memory instead of issuing its
        own backend round trip."""
        self._sync_store()
        page_ids = list(page_ids)
        with get_tracer().span("fault_group", kind="storage", model=model,
                               channel_name=self.storage.channel,
                               pages=len(page_ids)) as sp:
            self.store.fault_pages(page_ids)
            misses = sum(not hit for hit in self._access(model, page_ids))
            t = self.storage.fetch_group_seconds(self.page_bytes, misses)
            t += self._charge_hbm(misses)
            t += self._charge_faults()
            sp.set(misses=misses, bytes=misses * self.page_bytes,
                   seconds=t)
        self.stats.pages_fetched += misses
        self.stats.fetch_seconds += t
        return t

    # ---------------------------------------------- transfer double buffer --
    def prestage(self, page_ids) -> None:
        """Issue the host->HBM staging transfer for ``page_ids``'s
        missing pages *now* (async), ahead of the buffer pool admitting
        them: the engines call this for the next queued batch right
        before computing the current one, so the copy overlaps compute
        (a side CUDA stream) and the eventual commit finds the bytes
        already device-side."""
        if self.device_pool is None or self.transfer != "grouped":
            return
        self._sync_store()
        self.device_pool.transfer.stage(page_ids)

    def transfer_snapshot(self) -> Optional[Dict[str, float]]:
        """Cumulative transfer-engine counters (None on the numpy
        backend); the engines diff consecutive snapshots to attribute
        movement to batches in ``ServeStats``."""
        if self.device_pool is None:
            return None
        self.device_pool.transfer.resolve()      # fold CUDA-event timings
        s = self.device_pool.transfer.stats
        return {"seconds": s.seconds, "pages": s.pages, "bytes": s.bytes,
                "groups": s.groups,
                "overlapped_bytes": s.overlapped_bytes}

    def shard_resident_pages(self, shard: Optional[int] = None):
        """Resident page ids of one shard's pool — the admission
        probe's view of dedup affinity.  A single-slab server has
        exactly one 'shard'; :class:`~repro_torch.serving.shard_pool.
        ShardedWeightServer` overrides this with the per-shard pools so
        a routed batch is scored against the residency of the shard it
        would actually land on."""
        return self.pool.resident_pages()

    def tensor_pages(self, model: str, tensor: str) -> List[int]:
        return self.store.packing.tensor_pages[(model, tensor)]

    def fetch_tensor(self, model: str, tensor: str) -> np.ndarray:
        """Access all pages of a tensor, then materialize it."""
        with get_tracer().span("fetch_tensor", kind="storage",
                               model=model, tensor=tensor):
            self.access_pages(model, self.tensor_pages(model, tensor))
            return self.store.materialize(model, tensor)

    def embedding_rows_pages(self, model: str, tensor: str,
                             rows: np.ndarray) -> List[int]:
        """Pages containing the row blocks touched by ``rows`` (the
        paper's locality win: a batch only faults its own row blocks)."""
        vt = self.store.virtual_tensor(model, tensor)
        bh = self.store.cfg.dedup.block_shape[0]
        gw = vt.grid.grid[1]
        l = self.store.cfg.blocks_per_page
        row_blocks = np.unique(rows // bh)
        logical = (row_blocks[:, None] * gw
                   + np.arange(gw)[None, :]).reshape(-1)
        slots = vt.block_map[logical]
        return sorted(set(int(s) // l for s in slots))

    # ------------------------------------------------- device (HBM) path --
    def _device_map(self, model: str, tensor: str):
        vt = self.store.virtual_tensor(model, tensor)
        dev_map = self.device_pool.remap(vt, key=(model, tensor))
        return vt, dev_map

    def device_gather_rows(self, model: str, tensor: str, rows,
                           pad: bool = False, pages=None):
        """[n, width] rows of the tensor gathered straight from the HBM
        slab via the dedup-embedding kernel path; None when the required
        pages are not resident (the engine then falls back to the host in
        the CPU modes and raises in cuda mode).

        ``pages``: the page set covering ``rows`` (what the caller just
        faulted).  When given, only those pages must be resident — the
        working set may exceed the slab as long as each batch fits; when
        omitted, the tensor's whole page set must be resident."""
        self._sync_store()
        vt = self.store.virtual_tensor(model, tensor)
        if pages is not None:
            if not self.device_pool.pages_resident(pages):
                return None
            dev_map = self.device_pool.remap(vt, key=(model, tensor),
                                             strict=False)
        else:
            dev_map = self.device_pool.remap(vt, key=(model, tensor))
            if dev_map is None:
                return None
        return self.device_pool.gather_rows(dev_map, vt.grid, rows, pad=pad)

    def device_matmul(self, model: str, tensor: str, x):
        """``x @ W_virtual`` through dedup_matmul against the slab; None
        when the tensor's pages are not all resident."""
        self._sync_store()
        vt, dev_map = self._device_map(model, tensor)
        if dev_map is None:
            return None
        return self.device_pool.virtual_matmul(dev_map, vt.grid, x)

    def device_tensor(self, model: str, tensor: str):
        """Whole tensor reassembled on device from resident slab blocks
        (LM model-switch path: no host densification); None when not all
        pages are resident."""
        self._sync_store()
        vt, dev_map = self._device_map(model, tensor)
        if dev_map is None:
            return None
        return self.device_pool.unblock(dev_map, vt.grid)


# ------------------------------------------------------- embedding serving --
def _tok_logits(emb_tokens, head):
    """Mean-pool + head on the slab's device for the device path:
    ``emb_tokens`` [docs, tokens, d] -> logits [docs, classes]."""
    return emb_tokens.mean(dim=1) @ head


class _PrefetchingEngine:
    """Shared scheduler-engine plumbing: the per-batch prefetch step,
    transfer-stat attribution, and next-batch prestaging.  Subclasses
    provide ``prefetcher``, ``overlap``, ``timeline``, ``stats``,
    ``scheduler``, ``server``."""

    def _transfer_snap(self):
        return self.server.transfer_snapshot()

    def _add_transfer_delta(self, snap) -> None:
        """Fold the transfer engine's movement since ``snap`` into the
        stats (per-batch attribution; group_sizes gets this batch's
        pages-per-operation ratio: 1.0 on the per_page path)."""
        cur = self.server.transfer_snapshot()
        if snap is None or cur is None:
            return
        d_groups = cur["groups"] - snap["groups"]
        d_pages = cur["pages"] - snap["pages"]
        self.stats.transfer_seconds += cur["seconds"] - snap["seconds"]
        self.stats.transfer_bytes += cur["bytes"] - snap["bytes"]
        self.stats.transfer_overlapped_bytes += \
            cur["overlapped_bytes"] - snap["overlapped_bytes"]
        self.stats.transfer_pages += d_pages
        self.stats.transfer_groups += d_groups
        if d_groups > 0:
            self.stats.group_sizes.append(d_pages / d_groups)

    def _prestage_next(self) -> None:
        """Double buffer: issue the NEXT queued batch's host->HBM staging
        transfer before computing the current batch, so the copy rides
        under compute (a side CUDA stream).  Approximation: the head of
        the pending queue in arrival order — exact for fifo, a best
        guess for rotating schedulers (a wrong guess only wastes one
        staging buffer, it can never corrupt residency)."""
        if not self.overlap:
            return
        gen = self.server.store.pack_generation
        for b in self.scheduler.pending_batches()[:1]:
            if b.pages is None or b.pages_gen != gen:
                continue
            self.server.prestage(sorted(b.pages))

    def _maybe_prefetch(self) -> None:
        """Speculative I/O rides the fetch channel *under* compute,
        budgeted to the channel's idle headroom (compute clock minus
        fetch clock) so it never delays a demand fetch by more than one
        in-flight page transfer.  On a serial engine there is no idle
        channel to hide speculation in — every prefetched second would
        add to the makespan — so a prefetcher without ``overlap`` is
        deliberately inert."""
        if self.prefetcher is None or not self.overlap:
            return
        budget = self.timeline.compute_clock - self.timeline.fetch_clock
        if budget <= 0:
            return
        snap = self._transfer_snap()
        pf_t = self.prefetcher.step(budget)
        self._add_transfer_delta(snap)
        self.timeline.charge_fetch(pf_t)
        self.stats.prefetch_seconds += pf_t
        self.stats.prefetch_pages = self.prefetcher.stats.issued


class EmbeddingServingEngine(_PrefetchingEngine):
    """Paper Sec. 7.1.1/7.1.2 scenario: many embedding-model variants.

    ``scheduler``: a policy name (``fifo`` / ``round_robin`` /
    ``dedup_affinity``) or a :class:`BatchScheduler` instance.
    ``overlap=True`` switches demand fetches to grouped issue and runs
    them on the double-buffered timeline (fetch(t) ∥ compute(t-1));
    ``prefetcher`` (optional) additionally pulls hot models' pages during
    compute.  Defaults reproduce the old serial round-robin engine.
    """

    def __init__(self, server: WeightServer,
                 heads: Dict[str, np.ndarray],
                 embed_tensor: str = "embedding",
                 scheduler="round_robin",
                 prefetcher=None,
                 overlap: bool = False):
        self.server = server
        self.heads = heads
        self.embed_tensor = embed_tensor
        self.scheduler: BatchScheduler = make_scheduler(scheduler)
        self.prefetcher = prefetcher
        if prefetcher is not None and hasattr(prefetcher, "attach_scheduler"):
            prefetcher.attach_scheduler(self.scheduler)
        self.overlap = overlap
        self.timeline = FetchComputeTimeline()
        self.stats = ServeStats(overlapped=overlap)
        self.last_logits: Optional[np.ndarray] = None  # test/debug hook
        self._dev_heads: Dict[str, torch.Tensor] = {}  # model -> head

    def submit(self, model: str, docs: np.ndarray) -> None:
        """Queue a request batch; its page working set is estimated here
        (pure page-map arithmetic, no weight access) so the scheduler can
        do affinity placement without touching storage.  On a sharded
        server the router's placement decision rides along too (advisory:
        the server re-routes at run time, identically unless a repack
        intervened)."""
        rows = np.unique(docs)
        pages = self.server.embedding_rows_pages(model, self.embed_tensor,
                                                 rows)
        router = getattr(self.server, "router", None)
        shard = router.route(pages, record=False).shard \
            if router is not None else None
        self.scheduler.submit(model, docs, pages=pages,
                              pages_gen=self.server.store.pack_generation,
                              shard=shard)

    def _head_dev(self, model: str, like: torch.Tensor) -> torch.Tensor:
        """The model's head on the device (and in the dtype) of ``like``."""
        head = self._dev_heads.get(model)
        if head is None or head.device != like.device \
                or head.dtype != like.dtype:
            head = self._dev_heads[model] = torch.as_tensor(
                self.heads[model], dtype=like.dtype, device=like.device)
        return head

    def _infer(self, batch: ScheduledBatch) -> np.ndarray:
        model, docs = batch.model, batch.payload
        # Page ids cached at submit() die with the packing they were
        # minted under: recompute after any repack (model update between
        # submit and run) instead of faulting ids that now name other
        # bytes — or nothing.  The generation travels on the batch, so
        # later submits can't alias an older batch's ids as current.
        if batch.pages is not None and batch.pages_gen is not None \
                and self.server.store.packing_current(batch.pages_gen):
            pages = sorted(batch.pages)
        else:
            pages = self.server.embedding_rows_pages(
                model, self.embed_tensor, np.unique(docs))
        snap = self._transfer_snap()
        degraded = False
        tr = get_tracer()
        with tr.span("fetch", kind="engine", model=model,
                     pages=len(pages)) as fsp:
            try:
                if self.overlap:
                    fetch_t = self.server.access_pages_grouped(model, pages)
                else:
                    fetch_t = self.server.access_pages(model, pages)
            except StorageFaultError:
                # device-path access failed past its retry budget: in the
                # CPU modes degrade this batch to the host backend (the
                # materialize path below retries with a fresh budget)
                # instead of aborting the run; on the card, raise
                if not self.server.host_fallback_allowed():
                    raise
                degraded = True
                self.stats.degraded_batches += 1
                fetch_t = self.server._charge_faults()
            fsp.set(seconds=fetch_t, degraded=degraded)
        if self.prefetcher is not None:
            self.prefetcher.note_demand(pages)     # lookahead hit accounting
        # double buffer: next batch's host->HBM copy issues now, rides
        # under this batch's compute (side stream), commits next turn
        self._prestage_next()
        t0 = time.perf_counter()
        logits = None
        with tr.span("compute", kind="engine", model=model,
                     rows=int(docs.size)) as csp:
            if self.server.backend == "device" and not degraded:
                # Hot path: the batch's token rows come straight off the
                # resident slab through the dedup kernel path — no unique/
                # scatter bookkeeping, no host materialization of any weight.
                flat = docs.reshape(-1)
                try:
                    emb = self.server.device_gather_rows(
                        model, self.embed_tensor, flat, pad=True,
                        pages=pages)
                except StorageFaultError:
                    if not self.server.host_fallback_allowed():
                        raise
                    emb = None
                    self.stats.degraded_batches += 1
                if emb is None:
                    if not self.server.host_fallback_allowed():
                        raise RuntimeError(
                            f"batch of {model!r}: its pages are not all "
                            f"resident on the slab, and cuda mode does not "
                            f"fall back to the host")
                    self.stats.dense_fallbacks += 1
                else:
                    emb = emb[:flat.size].reshape(docs.shape
                                                  + (emb.shape[-1],))
                    if isinstance(emb, np.ndarray):
                        logits = emb.mean(axis=1) @ self.heads[model]
                    else:
                        # batch boundary: the logits leave the device here,
                        # and .cpu() waits for it inside the compute timer
                        logits = _tok_logits(
                            emb, self._head_dev(model, emb)
                        ).to(torch.float32).cpu().numpy()
                    self.stats.device_batches += 1
            csp.set(device=logits is not None)
            if logits is None:
                rows = np.unique(docs)
                emb_rows = self.server.store.materialize_rows(
                    model, self.embed_tensor, rows)
                idx = np.searchsorted(rows, docs)
                feats = emb_rows[idx].mean(axis=1)
                logits = feats @ self.heads[model]
        compute_t = time.perf_counter() - t0
        # recovery work triggered by compute-side materialization (host
        # fallback re-faulting pages) is charged here, not lost
        fetch_t += self.server._charge_faults()
        self.last_logits = logits
        self._add_transfer_delta(snap)

        if self.overlap:
            issue, done = self.timeline.advance(fetch_t, compute_t)
            self.stats.latencies.append(done - issue)
            self.stats.timeline_seconds = self.timeline.makespan
        else:
            # serial: fetch then compute on one channel; the timeline is
            # left untouched so makespan_seconds falls back to the sum
            self.stats.latencies.append(fetch_t + compute_t)
        self.stats.fetch_latencies.append(fetch_t)
        self.stats.fetch_seconds += fetch_t
        self.stats.compute_seconds += compute_t
        self.stats.requests += len(docs)
        self.stats.batches += 1
        return logits.argmax(axis=1)

    def run(self, max_batches: Optional[int] = None) -> ServeStats:
        """Drain the scheduler (each queue's drain rate is the lambda_i
        feeding Eq. 2 inside the buffer pool)."""
        tr = get_tracer()
        n = 0
        while self.scheduler.pending():
            batch = self.scheduler.next_batch(
                self.server.pool.resident_pages())
            if batch is None:
                break
            if tr.enabled:
                tr.event("schedule", kind="policy",
                         policy=self.scheduler.name, model=batch.model)
            self._infer(batch)
            self._maybe_prefetch()
            n += 1
            if max_batches and n >= max_batches:
                break
        if self.overlap:
            self.stats.timeline_seconds = self.timeline.makespan
        return self.stats


# --------------------------------------------------------------- LM serving --
class LMServingEngine(_PrefetchingEngine):
    """Serve LM variants with batched prefill/decode; weights are faulted
    in through the dedup page pool on model switch.

    ``generate`` keeps the direct call path; ``submit``/``run`` drive the
    same scheduler/timeline machinery as the embedding engine, with a
    model switch's whole page working set issued as one fetch group.

    ``apis``: model -> :class:`~repro_torch.models.ModelAPI`;
    ``params_template``: model -> ``{"rebuild": fn}``, where
    ``fn(tensors, device=None)`` turns the served tensors into the
    model's params (``repro_torch.convert.lm_tensors``).  The params are
    rebuilt once a model switch (the reference rebuilds them once a
    batch) and the prompts run on their device."""

    def __init__(self, server: WeightServer, apis: Dict[str, object],
                 params_template: Dict[str, dict],
                 scheduler="fifo", prefetcher=None, overlap: bool = False):
        self.server = server
        self.apis = apis
        self.templates = params_template     # model -> {"rebuild": fn}
        self.scheduler: BatchScheduler = make_scheduler(scheduler)
        self.prefetcher = prefetcher
        if prefetcher is not None and hasattr(prefetcher, "attach_scheduler"):
            prefetcher.attach_scheduler(self.scheduler)
        self.overlap = overlap
        self.timeline = FetchComputeTimeline()
        self.stats = ServeStats(overlapped=overlap)
        self.last_tokens: Optional[np.ndarray] = None  # test/frontend hook
        self.last_logits: Optional[torch.Tensor] = None  # prefill logits
        self._resident_model: Optional[str] = None
        self._params = None
        self._params_gen = -1          # packing generation of _params

    def _param_device(self):
        """Where host-materialized tensors go: the slab's device, the CPU
        without one."""
        pool = self.server.device_pool
        return pool.device if pool is not None and pool.device is not None \
            else torch.device("cpu")

    def _load_model(self, model: str, grouped: bool = False) -> float:
        """Fault the model's weights through the pool; returns the
        virtual fetch seconds (0 when already resident).

        On the device backend the model switch never densifies on the
        host: the page working set is faulted into the device slab and
        each tensor is reassembled *on the device* from resident slab
        blocks (``WeightServer.device_tensor``).  The CPU kernel modes
        fall back to host materialization when the slab cannot hold the
        working set or the fetch fails past its retry budget, as the
        reference does; cuda mode raises instead."""
        if self._resident_model == model and \
                self.server.store.packing_current(self._params_gen):
            return 0.0
        names = list(self.server.store.dedup.models[model].tensors)
        self._params = self._resident_model = None   # free the old model
        with get_tracer().span("model_switch", kind="engine",
                               model=model, grouped=grouped) as sp:
            if self.server.backend == "device":
                pages = self.server.store.model_pages(model)
                try:
                    if grouped:
                        fetch_t = self.server.access_pages_grouped(model,
                                                                   pages)
                    else:
                        fetch_t = self.server.access_pages(model, pages)
                    tensors = {}
                    for name in names:
                        dt = self.server.device_tensor(model, name)
                        if dt is None:
                            tensors = None
                            break
                        tensors[name] = dt
                except StorageFaultError:
                    # in the CPU modes degrade this model switch to host
                    # materialization (fresh retry budget); on the card,
                    # raise
                    if not self.server.host_fallback_allowed():
                        raise
                    self.stats.degraded_batches += 1
                    fetch_t = self.server._charge_faults()
                    tensors = None
                if tensors is None:
                    if not self.server.host_fallback_allowed():
                        raise RuntimeError(
                            f"model switch to {model!r}: its pages are not "
                            f"all resident on the slab, and cuda mode does "
                            f"not fall back to the host")
                    self.stats.dense_fallbacks += 1
                    tensors = {name: self.server.store.materialize(model,
                                                                   name)
                               for name in names}
                    fetch_t += self.server._charge_faults()
                else:
                    self.stats.device_batches += 1
            elif grouped:
                fetch_t = self.server.access_pages_grouped(
                    model, self.server.store.model_pages(model))
                tensors = {name: self.server.store.materialize(model, name)
                           for name in names}
            else:
                t0 = self.server.stats.fetch_seconds
                tensors = {}
                for name in names:
                    tensors[name] = self.server.fetch_tensor(model, name)
                fetch_t = self.server.stats.fetch_seconds - t0
            sp.set(seconds=fetch_t, tensors=len(names))
        self._params = self.templates[model]["rebuild"](
            tensors, device=self._param_device())
        self._resident_model = model
        self._params_gen = self.server.store.pack_generation
        return fetch_t

    def _compute(self, model: str, prompts: np.ndarray, steps: int
                 ) -> Tuple[np.ndarray, float]:
        """Prefill, then greedy decode with the tokens kept on the device;
        the timer ends after the tokens reach the host, so it holds the
        device work."""
        params, api = self._params, self.apis[model]
        dev = params["embed"].device
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(prompts), device=dev)
        logits, cache = api.prefill(params, {"tokens": tokens},
                                    prompts.shape[1] + steps)
        self.last_logits = logits
        out = [logits.argmax(-1)]
        for _ in range(steps - 1):
            logits, cache = api.decode(params, cache, out[-1])
            out.append(logits.argmax(-1))
        # batch boundary: the tokens leave the device once, here
        toks = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()  # repro: allow-host
        dt = time.perf_counter() - t0
        return toks, dt

    def generate(self, model: str, prompts: np.ndarray,
                 steps: int = 8) -> Tuple[np.ndarray, float]:
        snap = self._transfer_snap()
        fetch_t = self._load_model(model)
        out, dt = self._compute(model, prompts, steps)
        self.last_tokens = out
        self._add_transfer_delta(snap)
        if self.overlap:
            # keep the timeline live on the direct call path too, so
            # makespan_seconds stays well-defined for overlap engines
            self.timeline.advance(fetch_t, dt)
            self.stats.timeline_seconds = self.timeline.makespan
        self.stats.compute_seconds += dt
        self.stats.latencies.append(dt)
        self.stats.requests += len(prompts)
        self.stats.batches += 1
        return out, dt

    # -- scheduler-driven serving -------------------------------------------
    def submit(self, model: str, prompts: np.ndarray, steps: int = 8) -> None:
        pages = self.server.store.model_pages(model)
        router = getattr(self.server, "router", None)
        shard = router.route(pages, record=False).shard \
            if router is not None else None
        self.scheduler.submit(model, (prompts, steps), pages=pages,
                              pages_gen=self.server.store.pack_generation,
                              shard=shard)

    def run(self, max_batches: Optional[int] = None) -> ServeStats:
        tr = get_tracer()
        n = 0
        while self.scheduler.pending():
            batch = self.scheduler.next_batch(
                self.server.pool.resident_pages())
            if batch is None:
                break
            if tr.enabled:
                tr.event("schedule", kind="policy",
                         policy=self.scheduler.name, model=batch.model)
            prompts, steps = batch.payload
            snap = self._transfer_snap()
            fetch_t = self._load_model(batch.model, grouped=self.overlap)
            if self.prefetcher is not None:
                self.prefetcher.note_demand(
                    self.server.store.model_pages(batch.model))
            self._prestage_next()       # next model's pages ∥ this compute
            out, compute_t = self._compute(batch.model, prompts, steps)
            self.last_tokens = out
            self._add_transfer_delta(snap)
            if self.overlap:
                issue, done = self.timeline.advance(fetch_t, compute_t)
                self.stats.latencies.append(done - issue)
                self.stats.timeline_seconds = self.timeline.makespan
            else:
                self.stats.latencies.append(fetch_t + compute_t)
            self.stats.fetch_latencies.append(fetch_t)
            self.stats.fetch_seconds += fetch_t
            self.stats.compute_seconds += compute_t
            self.stats.requests += len(prompts)
            self.stats.batches += 1
            self._maybe_prefetch()
            n += 1
            if max_batches and n >= max_batches:
                break
        if self.overlap:
            self.stats.timeline_seconds = self.timeline.makespan
        return self.stats
