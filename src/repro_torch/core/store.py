"""ModelStore: the end-to-end deduplicated model repository (paper Fig. 3).

register -> dedup (Sec. 4) -> pack pages (Sec. 5) -> serve via buffer pool
(Sec. 6).  Persistence goes through a pluggable
:class:`~repro.storage.PageBackend` (local dir / SQLite / object-store
sim): ``save(backend)`` writes content-addressed pages in the store's
native page dtype plus a relational manifest, and ``ModelStore.open``
returns a *live* store whose pages stay paged in the backend and are
faulted in grouped on demand — the serving tiers (buffer pool, HBM slab)
source pages straight through it (DESIGN.md §2/§4).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from .blocks import BlockGrid, make_grid
from .bufferpool import BufferPool, PoolConfig
from .dedup import (DedupConfig, DedupResult, Deduplicator, Evaluator,
                    TensorEntry)
from .lsh import LSHConfig
from .pagepack import PackResult, check_coverage, pack
# storage is a lower layer (numpy-only, never imports core):
# the manifest version and dtype resolution live there once
from ..obs import get_tracer
from ..storage.backend import MANIFEST_VERSION, resolve_dtype
from ..storage.crashpoints import crash_point, register_crash_points
from ..storage.faults import (CorruptPageError, FatalStorageError,
                              RecoveryStats, RetryPolicy, fault_layer,
                              maybe_wrap)
from ..storage.journal import Journal, recover_backend

TensorRef = Tuple[str, str]

register_crash_points({
    "store.save.journaled":
        "save intent durably journaled, no page written yet",
    "store.save.pages_put":
        "fresh pages stored, manifest not yet committed",
    "store.save.manifest_committed":
        "manifest committed, orphan prune not yet run (the leak window)",
    "store.save.pruned":
        "orphans pruned, save intent not yet marked done",
})


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Knobs for dedup, page packing and the persisted page dtype."""
    dedup: DedupConfig = dataclasses.field(default_factory=DedupConfig)
    blocks_per_page: int = 16           # page size limit "l"
    pack_strategy: str = "two_stage"
    # dtype pages are *persisted* in: "auto" = the common dtype of the
    # registered tensors when uniform (fp16 models round-trip bit-exact
    # through fp16 pages instead of a float32 detour), float32 otherwise.
    page_dtype: str = "auto"


@dataclasses.dataclass
class VirtualTensor:
    """Device-servable representation: indices into the shared page pool."""
    grid: BlockGrid
    dtype: np.dtype
    block_map: np.ndarray        # [num_blocks] -> slot in the flattened pool
    page_ids: List[int]          # pages this tensor needs resident


class ModelStore:
    """The relational model store: deduplicated tensor blocks packed
    into pages, plus the packing/caching state every serving tier
    (buffer pool, device slab, shards) hangs off.  ``pack_generation``
    names the packing epoch; all downstream caches key on it."""

    def __init__(self, cfg: Optional[StoreConfig] = None):
        self.cfg = cfg or StoreConfig()
        self.dedup = Deduplicator(self.cfg.dedup)
        self._pack: Optional[PackResult] = None
        self._slot_of_block: Dict[int, Tuple[int, int]] = {}  # did -> (page, slot)
        # Packing generation: bumped on every repack().  Downstream caches
        # (WeightServer._pool_arr, DevicePagePool remaps, Prefetcher page
        # sets) key their validity on this counter, so a model update can
        # never leave a consumer serving a stale pool array.
        self.pack_generation = 0
        self._stack: Optional[np.ndarray] = None          # distinct blocks
        self._vt_cache: Dict[TensorRef, VirtualTensor] = {}
        self._page_pool_cache: Dict[str, Tuple[int, np.ndarray]] = {}
        # Backend attachment (set by ModelStore.open / save): pages not
        # yet faulted from the backend, their content hashes, and whether
        # the LSH index still needs rebuilding before the next mutation.
        self._backend = None                     # Optional[PageBackend]
        self._page_hash: List[str] = []          # pid -> content hash
        self._unfetched: Set[int] = set()        # pids still in the backend
        self._persisted_page_dtype = np.dtype(np.float32)
        self._index_stale = False
        # Recovery layer (DESIGN.md §8): every backend round trip goes
        # through retry_policy; fault_stats accumulates what recovery
        # cost (serving tiers snapshot-diff it per batch).  verify_pages
        # None = auto: sha256-check fetched pages iff a fault-injecting
        # layer is attached (the paranoid mode costs a hash per page).
        self.retry_policy = RetryPolicy()
        self.fault_stats = RecoveryStats()
        self.verify_pages: Optional[bool] = None

    def _mutate(self) -> None:
        """Invalidate everything derived from dedup state / packing."""
        self._pack = None
        self._stack = None
        self._vt_cache.clear()
        self._page_pool_cache.clear()

    def _hydrate(self) -> None:
        """Make an opened store fully mutable: fault every remaining page
        out of the backend and rebuild the LSH index so incremental dedup
        (register/update/remove) sees the reloaded blocks.  Serving paths
        never need this — they stay lazily paged."""
        if self._backend is None:
            return
        self.fault_all()
        if self._index_stale:
            self.dedup.rebuild_index()
            self._index_stale = False

    # ------------------------------------------------------------ pipeline --
    def register(self, model: str, tensors: Mapping[str, np.ndarray],
                 evaluator: Optional[Evaluator] = None,
                 layers=None) -> DedupResult:
        self._hydrate()
        res = self.dedup.add_model(model, dict(tensors), evaluator, layers)
        self._mutate()                           # packing is now stale
        return res

    def remove(self, model: str) -> None:
        self._hydrate()
        self.dedup.remove_model(model)
        self._mutate()

    def update(self, model: str, tensors: Mapping[str, np.ndarray],
               evaluator: Optional[Evaluator] = None,
               approach: int = 2) -> DedupResult:
        self._hydrate()
        res = self.dedup.update_model(model, dict(tensors), evaluator, approach)
        self._mutate()
        return res

    def repack(self) -> PackResult:
        """(Re)run Sec.-5 page packing over the current distinct blocks."""
        self._hydrate()      # page ids are about to be renamed: the lazy
        self._page_hash = [] # backend mapping below dies with them
        tensor_sets = self.dedup.tensor_sets()
        seqs = {(m, t): self.dedup.models[m].tensors[t].block_map
                for m in self.dedup.models
                for t in self.dedup.models[m].tensors}
        pk = pack(tensor_sets, self.cfg.blocks_per_page,
                  self.cfg.pack_strategy, tensor_seqs=seqs)
        check_coverage(pk, tensor_sets, self.cfg.blocks_per_page)
        self._install_pack(pk)
        return self._pack

    def _install_pack(self, pk: PackResult) -> None:
        """Adopt a packing (freshly computed or loaded from a manifest)
        and invalidate every packing-derived cache."""
        self._pack = pk
        self._slot_of_block = {}
        for pid, page in enumerate(pk.pages):
            for slot, did in enumerate(page):
                # A block may appear in several pages (Alg. 3 copies); keep
                # the first placement as canonical.
                self._slot_of_block.setdefault(did, (pid, slot))
        self._vt_cache.clear()
        self._page_pool_cache.clear()
        self.pack_generation += 1

    @property
    def packing(self) -> PackResult:
        if self._pack is None:
            self.repack()
        return self._pack

    def packing_current(self, generation: int) -> bool:
        """True iff page ids minted under ``generation`` are still valid:
        the store is packed and has not been repacked since.  Consumers
        holding derived page sets (queued batches, model-switch caches)
        gate on this before trusting them."""
        return self._pack is not None and self.pack_generation == generation

    # ------------------------------------------------------ backend paging --
    @property
    def backend(self):
        """The attached :class:`~repro.storage.PageBackend` (None for a
        purely in-memory store)."""
        return self._backend

    def _verification_enabled(self) -> bool:
        if self.verify_pages is not None:
            return self.verify_pages
        return fault_layer(self._backend) is not None

    def _charged_run(self, fn, describe: str):
        """``retry_policy.run`` with the retry cost charged to
        ``fault_stats`` whether the call recovers OR exhausts its budget
        (a failed call's retries/backoff are real recovery work — the
        FatalStorageError carries them as ``.outcome``)."""
        tr = get_tracer()
        try:
            result, outcome = self.retry_policy.run(fn, describe=describe)
        except FatalStorageError as exc:
            oc = getattr(exc, "outcome", None)
            if oc is not None:
                self.fault_stats.retries += oc.retries
                self.fault_stats.backoff_seconds += oc.backoff_seconds
                if tr.enabled:
                    tr.event("retry", kind="storage", op=describe,
                             retries=oc.retries, fatal=True,
                             backoff_s=oc.backoff_seconds)
            raise
        self.fault_stats.retries += outcome.retries
        self.fault_stats.backoff_seconds += outcome.backoff_seconds
        if tr.enabled and outcome.retries:
            tr.event("retry", kind="storage", op=describe,
                     retries=outcome.retries, fatal=False,
                     backoff_s=outcome.backoff_seconds)
        return result

    def _backend_get(self, hashes: List[str]) -> Dict[str, np.ndarray]:
        """One grouped ``get_pages`` with bounded retries; retry cost is
        accumulated in ``fault_stats`` (virtual seconds, never slept)."""
        return self._charged_run(
            lambda: self._backend.get_pages(hashes), describe="get_pages")

    def _page_bytes_ok(self, pid: int, got: Dict[str, np.ndarray]) -> bool:
        """End-to-end integrity: the content address IS the checksum —
        re-derive ``save()``'s sha256 over the fetched bytes."""
        raw = np.ascontiguousarray(
            np.asarray(got[self._page_hash[pid]])).tobytes()
        return hashlib.sha256(raw).hexdigest()[:24] == self._page_hash[pid]

    def _verify_and_refetch(self, want: List[int],
                            got: Dict[str, np.ndarray]) -> None:
        """Quarantine pages whose bytes fail verification and re-fetch
        them as their own grouped call (the rest of the batch proceeds);
        bounded attempts, then :class:`CorruptPageError`."""
        bad = [p for p in want if not self._page_bytes_ok(p, got)]
        attempts = 0
        while bad:
            self.fault_stats.corrupt_detected += len(bad)
            attempts += 1
            if attempts > max(1, self.retry_policy.max_retries):
                raise CorruptPageError(
                    f"pages {bad} still fail sha256 verification after "
                    f"{attempts - 1} grouped refetches")
            got.update(self._backend_get([self._page_hash[p] for p in bad]))
            self.fault_stats.refetch_pages += len(bad)
            bad = [p for p in bad if not self._page_bytes_ok(p, got)]

    def _drain_injected_latency(self) -> None:
        fl = fault_layer(self._backend)
        if fl is not None:
            self.fault_stats.latency_seconds += fl.drain_injected_latency()

    def fault_pages(self, page_ids) -> int:
        """Fault not-yet-resident pages out of the attached backend with
        ONE grouped ``get_pages`` call (the serving miss path: a batch's
        misses share a single backend round trip).  No-op for in-memory
        stores and already-faulted pages.  Returns pages fetched.

        Recovery semantics (DESIGN.md §8): transient backend errors are
        retried with bounded virtual backoff; when verification is on,
        every fetched page is sha256-checked against its content address
        and corrupt pages are quarantined + re-fetched as their own
        grouped call instead of crashing the batch."""
        if self._backend is None or not self._unfetched:
            return 0
        want = sorted(p for p in set(int(p) for p in page_ids)
                      if p in self._unfetched)
        if not want:
            return 0
        with get_tracer().span("get_pages", kind="storage",
                               backend=type(self._backend).__name__,
                               pages=len(want)) as sp:
            got = self._backend_get([self._page_hash[p] for p in want])
            if self._verification_enabled():
                self._verify_and_refetch(want, got)
            self._drain_injected_latency()
            sp.set(verified=self._verification_enabled())
        for pid in want:
            page = np.asarray(got[self._page_hash[pid]])
            if page.dtype.kind == "V":
                # a backend that can't self-describe extension dtypes
                # (.npy files of bfloat16 pages come back as void bytes)
                # defers to the manifest's page_dtype for interpretation
                page = page.view(self._persisted_page_dtype)
            blocks = page.astype(np.float32)     # working copies are fp32
            for slot, did in enumerate(self._pack.pages[pid]):
                if self.dedup.distinct[did] is None:
                    self.dedup.distinct[did] = np.array(blocks[slot],
                                                        copy=True)
            self._unfetched.discard(pid)
        self._stack = None                       # stack is now stale
        return len(want)

    def fault_all(self) -> int:
        """Fault every remaining page (host-densification paths)."""
        if not self._unfetched:
            return 0
        return self.fault_pages(list(self._unfetched))

    def native_page_dtype(self) -> np.dtype:
        """The dtype pages are persisted in: ``cfg.page_dtype`` when set,
        else the registered tensors' common dtype when uniform and a
        narrow float (fp16/bf16/fp32 round-trip bit-exact), else fp32."""
        if self.cfg.page_dtype != "auto":
            return resolve_dtype(self.cfg.page_dtype)
        dts = {np.dtype(e.dtype) for res in self.dedup.models.values()
               for e in res.tensors.values()}
        if len(dts) == 1:
            dt = dts.pop()
            if dt.name in ("float16", "bfloat16", "float32"):
                return dt
        return np.dtype(np.float32)

    # ----------------------------------------------------------- accessors --
    def num_pages(self) -> int:
        return self.packing.num_pages

    def storage_bytes(self, dtype=np.float32) -> int:
        bh, bw = self.cfg.dedup.block_shape
        itemsize = np.dtype(dtype).itemsize
        return self.packing.num_pages * self.cfg.blocks_per_page * bh * bw * itemsize

    def dense_bytes(self, dtype=np.float32) -> int:
        """Storage without dedup: every model's logical blocks, paged."""
        bh, bw = self.cfg.dedup.block_shape
        itemsize = np.dtype(dtype).itemsize
        l = self.cfg.blocks_per_page
        pages = 0
        for m in self.dedup.models.values():
            for e in m.tensors.values():
                pages += -(-e.grid.num_blocks // l)
        return pages * l * bh * bw * itemsize

    def materialize(self, model: str, tensor: str) -> np.ndarray:
        if self._unfetched:
            # fault only this tensor's cover pages (stays paged per model)
            self.fault_pages(self.packing.tensor_pages[(model, tensor)])
        return self.dedup.materialize(model, tensor)

    def _distinct_stack(self) -> np.ndarray:
        """[len(distinct), bh, bw] float32 stack of the distinct blocks
        (tombstones as zeros), cached until the next register/update/remove.
        All the vectorized gathers below index into this one array.  On a
        backend-attached store this is the host-densification path, so it
        faults everything still paged (unfetched blocks must never be
        silently read as tombstone zeros)."""
        if self._unfetched:
            self.fault_all()
        if self._stack is None \
                or self._stack.shape[0] != len(self.dedup.distinct):
            self._stack = self.dedup.pool(np.float32)
        return self._stack

    def materialize_rows(self, model: str, tensor: str,
                         rows: np.ndarray) -> np.ndarray:
        """Gather only the requested rows (2-D tensors): the serving path's
        partial materialization — touches just the row blocks involved.
        Fully vectorized: one fancy-index gather pulls exactly the
        requested rows out of the stacked distinct-block array.

        On a backend-attached store only the pages covering the touched
        blocks are faulted (one grouped get), so the numpy serving path
        stays paged per batch instead of densifying the whole store on
        its first request."""
        e = self.dedup.models[model].tensors[tensor]
        bh, bw = e.grid.block_shape
        gw = e.grid.grid[1]
        width = e.grid.shape2d[1]
        rows = np.asarray(rows)
        rb = rows // bh
        off = rows % bh
        dids = e.block_map[rb[:, None] * gw + np.arange(gw)[None, :]]
        if self._unfetched:
            uniq = np.unique(dids)
            self.fault_pages({self._slot_of_block[int(d)][0] for d in uniq})
        if self._unfetched:
            # other pages still live in the backend: gather through a
            # small sub-stack of just the touched distinct blocks
            uniq = np.unique(dids)
            sub = np.stack([self.dedup.distinct[int(d)] for d in uniq])
            out = sub[np.searchsorted(uniq, dids), off[:, None], :]
        else:
            out = self._distinct_stack()[dids, off[:, None], :]
        return np.ascontiguousarray(            # [n, gw, bw] rows only
            out.reshape(len(rows), gw * bw)[:, :width], dtype=np.float32)

    def _page_slot_ids(self) -> np.ndarray:
        """[num_pages, blocks_per_page] distinct-id matrix of the packing
        (-1 marks an unfilled slot in a non-full page), cached per
        packing generation (page_pool and the grouped transfer staging
        path both gather through it)."""
        pk = self.packing
        hit = self._page_pool_cache.get("__slot_ids__")
        if hit is not None and hit[0] == self.pack_generation:
            return hit[1]
        l = self.cfg.blocks_per_page
        ids = np.full((pk.num_pages, l), -1, dtype=np.int64)
        for pid, page in enumerate(pk.pages):
            ids[pid, :len(page)] = page
        self._page_pool_cache["__slot_ids__"] = (self.pack_generation, ids)
        return ids

    def page_stack(self, page_ids, dtype=np.float32) -> np.ndarray:
        """[k, blocks_per_page, bh, bw] stack of the requested pages —
        the grouped transfer staging buffer.  One grouped backend fault
        (:meth:`fault_pages`) plus one vectorized gather, never k
        :meth:`page_array` calls (each of which would issue its own
        backend round trip on a freshly opened store)."""
        pids = [int(p) for p in page_ids]
        bh, bw = self.cfg.dedup.block_shape
        l = self.cfg.blocks_per_page
        if self._unfetched:
            self.fault_pages(pids)
        if self._unfetched:
            # other pages still live in the backend: assemble page by
            # page from already-faulted blocks, no full densification
            out = np.zeros((len(pids), l, bh, bw), dtype=dtype)
            for i, pid in enumerate(pids):
                page = self.packing.pages[pid]
                for slot, did in enumerate(page):
                    b = self.dedup.distinct[did]
                    if b is not None:
                        out[i, slot] = b
            return out
        ids = self._page_slot_ids()[np.asarray(pids, dtype=np.int64)]
        out = self._distinct_stack()[np.clip(ids, 0, None)].astype(
            dtype, copy=True)
        out[ids < 0] = 0
        return out

    def page_pool(self, dtype=np.float32) -> np.ndarray:
        """[num_pages, blocks_per_page, bh, bw] physical page array.

        Built by one vectorized gather from the distinct-block stack and
        cached per packing generation, so repeated callers (WeightServer,
        benchmarks) never re-run the old nested Python loops."""
        self.packing         # may repack: read before the generation
        key = np.dtype(dtype).str
        hit = self._page_pool_cache.get(key)
        if hit is not None and hit[0] == self.pack_generation:
            return hit[1]
        ids = self._page_slot_ids()
        pool = self._distinct_stack()[np.clip(ids, 0, None)].astype(
            dtype, copy=True)
        pool[ids < 0] = 0
        self._page_pool_cache[key] = (self.pack_generation, pool)
        return pool

    def page_array(self, pid: int, dtype=np.float32) -> np.ndarray:
        """One physical page [blocks_per_page, bh, bw] — what a device
        page pool transfers host->HBM on a buffer-pool miss, without
        building the whole pool array.  On a backend-attached store the
        page is faulted from the backend on first touch (the HBM slab
        sources its pages straight through the storage tier)."""
        bh, bw = self.cfg.dedup.block_shape
        page = self.packing.pages[pid]
        out = np.zeros((self.cfg.blocks_per_page, bh, bw), dtype=dtype)
        if self._unfetched:
            self.fault_pages([pid])
        if self._unfetched:
            # other pages still live in the backend: assemble this page
            # from its own blocks without densifying the whole stack
            for slot, did in enumerate(page):
                b = self.dedup.distinct[did]
                if b is not None:
                    out[slot] = b
            return out
        out[:len(page)] = self._distinct_stack()[np.asarray(page)]
        return out

    def virtual_tensor(self, model: str, tensor: str) -> VirtualTensor:
        """Indirection view used by the Pallas dedup kernels: block_map maps
        each logical block to a flat slot ``page * l + slot``.

        Slot-remap contract: every flat slot lies inside one of the
        tensor's *own* cover pages (``page_ids``), so a consumer that
        faults exactly ``page_ids`` resident (e.g. the device page pool)
        can always rewrite the map into its slot space.  The flat map is
        vectorized and cached per packing generation."""
        pk = self.packing
        key: TensorRef = (model, tensor)
        hit = self._vt_cache.get(key)
        if hit is not None:
            return hit
        e = self.dedup.models[model].tensors[tensor]
        l = self.cfg.blocks_per_page
        page_ids = sorted(set(pk.tensor_pages[key]))
        # did -> flat slot, restricted to this tensor's cover pages
        # (first placement in page-id order wins, matching _slot_of_block).
        slot_arr = np.full(len(self.dedup.distinct), -1, dtype=np.int64)
        for pid in reversed(page_ids):
            page = pk.pages[pid]
            slot_arr[np.asarray(page, dtype=np.int64)] = \
                pid * l + np.arange(len(page))
        flat = slot_arr[e.block_map].astype(np.int32)
        assert (flat >= 0).all(), \
            f"tensor {key}: block map escapes its cover pages"
        vt = VirtualTensor(e.grid, e.dtype, flat, page_ids)
        self._vt_cache[key] = vt
        return vt

    # ------------------------------------------------------------- serving --
    def page_sharers(self) -> Dict[int, frozenset]:
        """page id -> models whose tensors live (partly) on that page.
        This is the sharing structure Eq. 2 superposes rates over, and
        what the dedup-affinity scheduler co-schedules on."""
        sharers: Dict[int, set] = {}
        for (m, t), pids in self.packing.tensor_pages.items():
            for p in pids:
                sharers.setdefault(p, set()).add(m)
        return {p: frozenset(ms) for p, ms in sharers.items()}

    def page_sharer_counts(self) -> np.ndarray:
        """[num_pages] int64 sharer counts (|page_sharers()[p]|), cached
        per packing generation — the dedup statistic sharer-weighted
        shard placement keys on (hot shared pages replicate, singletons
        partition)."""
        hit = self._page_pool_cache.get("__sharer_counts__")
        if hit is not None and hit[0] == self.pack_generation:
            return hit[1]
        counts = np.zeros(self.packing.num_pages, dtype=np.int64)
        for p, ms in self.page_sharers().items():
            counts[p] = len(ms)
        self._page_pool_cache["__sharer_counts__"] = (self.pack_generation,
                                                      counts)
        return counts

    def model_pages(self, model: str) -> List[int]:
        """All pages the model's tensors touch (its page working set)."""
        pk = self.packing
        pages: set = set()
        for (m, t), pids in pk.tensor_pages.items():
            if m == model:
                pages.update(pids)
        return sorted(pages)

    def page_metadata(self) -> Tuple[Dict[int, frozenset],
                                     Dict[int, frozenset]]:
        """(page_sharers, page_locality) for the current packing — the
        Eq.-2 sharing structure and the locality-set (equivalence-class)
        grouping the pool policies consume."""
        pk = self.packing
        sharers = self.page_sharers()
        locality: Dict[int, frozenset] = {}
        owners: Dict[int, set] = {}
        for (m, t), pids in pk.tensor_pages.items():
            for p in pids:
                owners.setdefault(p, set()).add((m, t))
        for p, ts in owners.items():
            locality[p] = frozenset(ts)          # locality set = equivalence class
        return sharers, locality

    def make_buffer_pool(self, capacity_pages: int,
                         policy: str = "optimized_mru",
                         on_load=None, on_evict=None,
                         on_load_group=None, **kw) -> BufferPool:
        """``on_load``/``on_evict`` attach a backing tier (e.g. the device
        page pool's host->HBM transfers) to the policy simulator;
        ``on_load_group`` attaches the grouped transfer path (a batch's
        misses flush as one physical movement)."""
        sharers, locality = self.page_metadata()
        return BufferPool(PoolConfig(capacity_pages, policy, **kw),
                          page_sharers=sharers, page_locality=locality,
                          on_load=on_load, on_evict=on_evict,
                          on_load_group=on_load_group)

    # --------------------------------------------------------- persistence --
    def save(self, dest=None) -> Dict:
        """Persist the store through a :class:`~repro.storage.PageBackend`.

        ``dest`` may be a backend instance, a storage URL (``file://``,
        ``sqlite://``, ``objsim://``), a bare directory path (deprecated
        legacy spelling, resolved to a ``LocalDirBackend``), or None to
        reuse the backend the store was opened from.

        Pages are content-addressed (sha256 of the serialized bytes) in
        the store's :meth:`native_page_dtype`, so fp16/bf16 model sets
        round-trip bit-exact without a float32 detour.  The manifest
        commit is atomic/transactional, and pages orphaned by an earlier
        packing generation are pruned afterwards (``delete_pages`` on
        the diff).  The whole sequence is bracketed by a write-ahead
        intent journal: a crash at any seam leaves at worst
        unreferenced extra pages and staging files, which the journal
        replay on the next :meth:`open` garbage-collects (DESIGN.md §11).
        """
        from ..storage import PageBackend, open_backend
        if dest is None:
            if self._backend is None:
                raise ValueError("store has no attached backend; "
                                 "pass a backend, URL, or path to save()")
            backend = self._backend
        elif isinstance(dest, PageBackend):
            backend = dest
        else:
            # URL/path attach point: chaos mode (REPRO_FAULTS) wraps the
            # resolved backend; explicitly constructed instances above
            # are never wrapped (tests assert exact call counts on them)
            backend = maybe_wrap(open_backend(dest))
        pk = self.packing
        page_dtype = self.native_page_dtype()
        pool = self.page_pool().astype(page_dtype)
        page_hashes: List[str] = []
        payload: Dict[str, np.ndarray] = {}
        for pid in range(pk.num_pages):
            raw = np.ascontiguousarray(pool[pid]).tobytes()
            h = hashlib.sha256(raw).hexdigest()[:24]
            page_hashes.append(h)
            payload.setdefault(h, pool[pid])     # dedup in the backend too
        existing = set(backend.list_pages())
        fresh = {h: arr for h, arr in payload.items() if h not in existing}
        # Write-ahead intent (DESIGN.md §11): the keep-set names exactly
        # the pages the new manifest will reference, so recovery after a
        # crash at ANY point below reduces to one manifest-vs-stored GC.
        journal = Journal(backend)
        intent = journal.begin("save", keep=sorted(set(page_hashes)))
        crash_point("store.save.journaled")
        # content-addressed puts are idempotent, so transient write
        # failures (including torn acks) are safely retried
        self._charged_run(lambda: backend.put_pages(fresh),
                          describe="put_pages")
        crash_point("store.save.pages_put")
        manifest = {
            "version": MANIFEST_VERSION,
            "blocks_per_page": self.cfg.blocks_per_page,
            "block_shape": list(self.cfg.dedup.block_shape),
            "page_dtype": page_dtype.name,
            "pack_strategy": self.cfg.pack_strategy,
            "dedup_config": _dedup_config_dict(self.cfg.dedup),
            "pages": [{"hash": h, "blocks": [int(b) for b in pk.pages[i]]}
                      for i, h in enumerate(page_hashes)],
            "models": {
                m: {t: {"shape": list(e.grid.tensor_shape),
                        "dtype": np.dtype(e.dtype).name,
                        "block_map": e.block_map.tolist(),
                        "pages": [int(p) for p in pk.tensor_pages[(m, t)]]}
                    for t, e in res.tensors.items()}
                for m, res in self.dedup.models.items()},
        }
        # atomic commit point — retried on transient faults (a torn
        # commit re-commits idempotently: the version check passes after
        # the first, acked-or-not, success); ManifestConflictError stays
        # a hard conflict and propagates untouched
        self._charged_run(lambda: backend.commit_manifest(manifest),
                          describe="commit_manifest")
        crash_point("store.save.manifest_committed")
        orphans = existing - set(page_hashes)
        if orphans:                              # pages of older packings
            backend.delete_pages(sorted(orphans))
        crash_point("store.save.pruned")
        journal.commit(intent)
        if self._backend is None:
            self._backend = backend              # adopt for future save()
        return manifest

    @classmethod
    def open(cls, source, cfg: Optional[StoreConfig] = None) -> "ModelStore":
        """Open a saved store as a *live* ModelStore: pages stay paged in
        the backend and fault in lazily (grouped) as serving touches
        them — nothing is densified up front.

        ``source`` is a backend instance or storage URL.  ``cfg``
        overrides the persisted configuration (e.g. a different LSH
        seed); by default the manifest's own dedup/packing config is
        restored, so ``register``/``update`` after open dedup against
        the reloaded blocks exactly as before the restart.
        """
        from ..storage import PageBackend, open_backend
        if isinstance(source, PageBackend):
            backend = source
        else:
            backend = maybe_wrap(open_backend(source))
        # Journal replay (DESIGN.md §11): a crash mid-save leaves a
        # pending intent; recovery GCs orphan pages + temp debris before
        # anything reads the store.  Clean journals cost one read — no
        # page listing — so lazy-open call-count contracts are unchanged.
        recover_backend(backend)
        manifest, _ = RetryPolicy().run(backend.load_manifest,
                                        describe="load_manifest")
        version = manifest.get("version", 1)    # v1: pre-PageBackend saves
        if version > MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {version} from {backend.url()} is newer "
                f"than this build understands ({MANIFEST_VERSION}); "
                "upgrade the reader instead of guessing at the format")
        bh, bw = manifest["block_shape"]
        if cfg is None:
            cfg = _config_from_manifest(manifest)
        store = cls(cfg)
        dd = store.dedup
        pages = manifest["pages"]
        n_distinct = 1 + max((int(b) for e in pages for b in e["blocks"]),
                             default=-1)
        dd.distinct = [None] * n_distinct
        dd.owners = [dict() for _ in range(n_distinct)]
        tensor_pages: Dict[TensorRef, List[int]] = {}
        for m, tensors in manifest["models"].items():
            res = DedupResult(model=m, tensors={})
            for t, spec in tensors.items():
                grid = make_grid(tuple(spec["shape"]), (bh, bw))
                bm = np.asarray(spec["block_map"], dtype=np.int64)
                res.tensors[t] = TensorEntry(t, grid,
                                             resolve_dtype(spec["dtype"]),
                                             bm)
                res.total_blocks += grid.num_blocks
                tensor_pages[(m, t)] = [int(p) for p in spec["pages"]]
                ref: TensorRef = (m, t)
                uniq, cnt = np.unique(bm, return_counts=True)
                for did, c in zip(uniq, cnt):
                    dd.owners[int(did)][ref] = \
                        dd.owners[int(did)].get(ref, 0) + int(c)
                res.deduped_blocks += int(grid.num_blocks - len(uniq))
            dd.models[m] = res
        store._install_pack(PackResult([list(map(int, e["blocks"]))
                                        for e in pages],
                                       tensor_pages, strategy="loaded"))
        store._backend = backend
        store._page_hash = [e["hash"] for e in pages]
        store._unfetched = set(range(len(pages)))
        store._persisted_page_dtype = resolve_dtype(
            manifest.get("page_dtype", "float32"))
        store._index_stale = True                # rebuilt on first mutation
        return store


def _dedup_config_dict(cfg: DedupConfig) -> Dict:
    lsh = cfg.lsh
    return {
        "magnitude_stat": cfg.magnitude_stat,
        "validate_every_k": cfg.validate_every_k,
        "accuracy_drop_threshold": cfg.accuracy_drop_threshold,
        "validate": cfg.validate,
        "lsh": {"num_bands": lsh.num_bands,
                "rows_per_band": lsh.rows_per_band,
                "r": lsh.r,
                "collision_threshold": lsh.collision_threshold,
                "seed": lsh.seed},
    }


def _config_from_manifest(manifest: Dict) -> StoreConfig:
    bh, bw = manifest["block_shape"]
    dc = manifest.get("dedup_config", {})
    lsh = dc.get("lsh", {})
    return StoreConfig(
        dedup=DedupConfig(
            block_shape=(bh, bw),
            lsh=LSHConfig(**lsh) if lsh else LSHConfig(),
            magnitude_stat=dc.get("magnitude_stat", "q3"),
            validate_every_k=dc.get("validate_every_k", 64),
            accuracy_drop_threshold=dc.get("accuracy_drop_threshold", 0.035),
            validate=dc.get("validate", True)),
        blocks_per_page=manifest["blocks_per_page"],
        pack_strategy=manifest.get("pack_strategy", "two_stage"),
        page_dtype=manifest.get("page_dtype", "auto"))


def load_store_tensors(source) -> Dict[str, Dict[str, np.ndarray]]:
    """Rehydrate every model's tensors from a saved store (DEPRECATED:
    densifies everything on the host — prefer ``ModelStore.open``, which
    keeps pages paged in the backend).  ``source`` is a directory path
    (the legacy call convention), storage URL, or backend."""
    store = ModelStore.open(source)
    return {m: {t: store.materialize(m, t)
                for t in store.dedup.models[m].tensors}
            for m in store.dedup.models}
