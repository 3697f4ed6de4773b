"""Sharded page-pool serving: the dedup page pool partitioned across
per-shard slabs with dedup-aware placement and cross-shard borrowing.

Counterpart of ``repro.serving.shard_pool``, with the reference's names
and logic.  When the deduplicated page pool outgrows one slab, the pool
shards instead of thrashing that slab (DESIGN.md §5):

  * **Placement** — a total, deterministic ``page -> shards`` map,
    rebuilt per packing generation.  ``hash`` is ``pid % num_shards``;
    ``sharers`` replicates the hottest shared pages on every shard (up to
    ``replicate_frac`` of a shard's capacity) and partitions the rest by
    model affinity.
  * **Per-shard pools** — each shard has its own
    :class:`~repro_torch.core.bufferpool.BufferPool` driving its own
    :class:`~repro_torch.serving.device_pool.DevicePagePool` slab, on the
    device :func:`~repro_torch.launch.mesh.shard_devices` gives it (on one
    GPU every shard shares ``cuda:0``).  Each shard's slab equals its
    pool's resident set, and a page is only ever resident on a shard its
    placement assigned it (``on_load`` raises otherwise).
  * **Borrow staging** — the minority pages of a routed batch (owned
    elsewhere, ``serving/router.py``) are staged into the executing
    shard's slab tail (``capacity + stage_idx``, ``DevicePagePool.
    write_stage``), so one extended remap serves the whole batch through
    the same kernels.  Where the reference copies an owner's host mirror,
    the port's cuda and torch modes, which keep no mirror, copy the
    owner's slab rows device to device (one ``index_select`` and one
    ``index_copy_`` per owner); a page that comes from the store goes up
    in one copy per batch.  Host mode keeps the reference's numpy path.
    The tail is written when the staging changes, so there is no
    separate sync before a compute call.

:class:`ShardedWeightServer` packages this behind the
:class:`~repro_torch.serving.engine.WeightServer` surface the engines
drive.  Like the single slab, it never moves a batch to the host in cuda
mode: a borrow set the staging tail cannot hold raises there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.bufferpool import BufferPool
from ..core.store import ModelStore, VirtualTensor
from ..obs import get_tracer
from .device_pool import DevicePagePool
from .engine import ServeStats, StorageModel, WeightServer
from .router import RouteDecision, ShardRouter

__all__ = ["PLACEMENTS", "Placement", "hash_placement", "sharers_placement",
           "make_placement", "ShardedPagePool", "ShardedWeightServer"]

PLACEMENTS = ("hash", "sharers")


# --------------------------------------------------------------- placement --
@dataclasses.dataclass(frozen=True)
class Placement:
    """Total, deterministic page->shards assignment for one packing."""
    num_shards: int
    policy: str
    owners: Tuple[Tuple[int, ...], ...]   # pid -> sorted owning shards
    owned_sets: Tuple[frozenset, ...]     # shard -> pages it owns
    replicated: frozenset                 # pages with >1 owner
    pack_generation: int

    def shards_of(self, pid: int) -> Tuple[int, ...]:
        return self.owners[pid]

    def primary(self, pid: int) -> int:
        return self.owners[pid][0]


def _finalize(owners: List[Tuple[int, ...]], num_shards: int, policy: str,
              generation: int) -> Placement:
    owned: List[set] = [set() for _ in range(num_shards)]
    for pid, ss in enumerate(owners):
        assert ss, f"placement left page {pid} unowned"
        for s in ss:
            owned[s].add(pid)
    replicated = frozenset(p for p, ss in enumerate(owners) if len(ss) > 1)
    return Placement(num_shards, policy, tuple(owners),
                     tuple(frozenset(s) for s in owned), replicated,
                     generation)


def hash_placement(num_pages: int, num_shards: int,
                   generation: int = 0) -> Placement:
    """Baseline: ``pid % num_shards``.  Total, deterministic, single
    owner, placement-oblivious — every batch borrows ~(S-1)/S of its
    cover set."""
    owners = [(pid % num_shards,) for pid in range(num_pages)]
    return _finalize(owners, num_shards, "hash", generation)


def sharers_placement(num_pages: int, num_shards: int,
                      sharers: Dict[int, frozenset],
                      replicate_budget: Optional[int] = None,
                      generation: int = 0) -> Placement:
    """Dedup-aware placement from ``ModelStore.page_sharers()``.

    Pages shared by >= 2 models are replicated on every shard, hottest
    (most sharers) first, up to ``replicate_budget`` pages (None:
    unbounded).  The rest partitions by model affinity: singleton pages
    anchor to their one sharer, models are greedily bin-packed
    (descending page weight) onto the least-loaded shard, and each
    over-budget shared page lands on the least-loaded home shard of one
    of its sharers.  Ties break by page id / model name / shard id, so
    two rebuilds over the same packing always agree.
    """
    owners: List[Optional[Tuple[int, ...]]] = [None] * num_pages
    shared: List[int] = []
    if num_shards > 1:
        shared = sorted((p for p in range(num_pages)
                         if len(sharers.get(p, ())) >= 2),
                        key=lambda p: (-len(sharers[p]), p))
        budget = len(shared) if replicate_budget is None \
            else max(0, int(replicate_budget))
        for p in shared[:budget]:
            owners[p] = tuple(range(num_shards))
        shared = shared[budget:]                 # partitioned below
    # singleton pages anchor their one sharer; model homes bin-pack
    shared_set = set(shared)
    singles = [p for p in range(num_pages)
               if owners[p] is None and p not in shared_set]
    anchor: Dict[int, Optional[str]] = {}
    weight: Dict[Optional[str], int] = {}
    for p in singles:
        ms = sharers.get(p)
        a = min(ms) if ms else None
        anchor[p] = a
        weight[a] = weight.get(a, 0) + 1
    load = [0] * num_shards
    home: Dict[Optional[str], int] = {}
    for m in sorted(weight, key=lambda m: (-weight[m], str(m))):
        s = min(range(num_shards), key=lambda i: (load[i], i))
        home[m] = s
        load[s] += weight[m]
    for p in singles:
        owners[p] = (home[anchor[p]],)
    # over-budget shared pages: least-loaded home among their sharers
    for p in shared:
        cand = sorted({home[m] for m in sharers.get(p, ()) if m in home})
        if not cand:
            cand = list(range(num_shards))
        s = min(cand, key=lambda i: (load[i], i))
        owners[p] = (s,)
        load[s] += 1
    return _finalize(owners, num_shards, "sharers", generation)  # type: ignore[arg-type]


def make_placement(policy: str, store: ModelStore, num_shards: int,
                   replicate_budget: Optional[int] = None) -> Placement:
    """Build a placement for the store's *current* packing."""
    if policy not in PLACEMENTS:
        raise ValueError(f"unknown placement {policy!r}; have {PLACEMENTS}")
    pk = store.packing                     # settle the packing first: the
    gen = store.pack_generation            # getter may repack (gen bump)
    if policy == "hash":
        return hash_placement(pk.num_pages, num_shards, gen)
    return sharers_placement(pk.num_pages, num_shards, store.page_sharers(),
                             replicate_budget, gen)


# -------------------------------------------------------------- shard pool --
class ShardedPagePool:
    """N per-shard (BufferPool, DevicePagePool) pairs + placement +
    borrow staging.  Also quacks like a single ``DevicePagePool`` for
    aggregate reporting (``capacity`` / ``loads`` / ``evicts`` /
    ``mode()`` / ``device``)."""

    def __init__(self, store: ModelStore, num_shards: int,
                 capacity_per_shard: int, placement: str = "sharers",
                 policy: str = "optimized_mru", kernel_mode: str = "auto",
                 replicate_frac: float = 0.5,
                 borrow_capacity: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 transfer: str = "grouped"):
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"have {PLACEMENTS}")
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if transfer not in WeightServer.TRANSFERS:
            raise ValueError(f"unknown transfer mode {transfer!r}; "
                             f"have {WeightServer.TRANSFERS}")
        self.store = store
        self.num_shards = int(num_shards)
        self.capacity_per_shard = int(capacity_per_shard)
        self.placement_policy = placement
        self.replicate_frac = float(replicate_frac)
        self.transfer = transfer
        self.borrow_capacity = int(borrow_capacity
                                   if borrow_capacity is not None
                                   else capacity_per_shard)
        devs = list(devices) if devices else []
        # stage_rows: each shard's slab carries a borrow-staging TAIL
        # past its resident slots, so extended remaps read one stable
        # buffer — no per-compute-call slab concatenation.
        self.pools: List[DevicePagePool] = [
            DevicePagePool(store, self.capacity_per_shard,
                           kernel_mode=kernel_mode,
                           device=devs[s % len(devs)] if devs else None,
                           stage_rows=self.borrow_capacity)
            for s in range(self.num_shards)]
        self._staged: List[Dict[int, int]] = [dict()
                                              for _ in range(self.num_shards)]
        self._placement_obj: Optional[Placement] = None
        self.buffer_pools: List[BufferPool] = [
            store.make_buffer_pool(
                self.capacity_per_shard, policy,
                on_load=self._mk_on_load(s),
                on_evict=self.pools[s].evict,
                on_load_group=(self._mk_on_load_group(s)
                               if transfer == "grouped" else None))
            for s in range(self.num_shards)]
        self.view = _ShardedPoolView(self)
        self.borrow_mirror_hits = 0
        self.borrow_store_faults = 0
        self.borrow_coalesced = 0
        # compute calls whose block map reached into a staging tail, by
        # entry point (in cuda mode one kernel launch each)
        self.tail_reads: Dict[str, int] = {"gather_rows": 0,
                                           "virtual_matmul": 0,
                                           "unblock": 0}
        # Failover state (DESIGN.md §8): dead shards take no traffic,
        # hold no pages, and their owned pages serve via the borrow
        # staging path from surviving owners or the store.
        self.dead: Set[int] = set()
        self.failovers = 0

    def _check_owner(self, shard: int, pid: int) -> None:
        owners = self.placement().shards_of(pid)
        if shard not in owners:
            raise RuntimeError(
                f"placement invariant violated: page {pid} loading on "
                f"shard {shard} but placement assigned {owners}")

    def _mk_on_load(self, shard: int):
        def on_load(pid):
            pid = int(pid)
            self._check_owner(shard, pid)
            self.pools[shard].load(pid)
        return on_load

    def _mk_on_load_group(self, shard: int):
        def on_load_group(pids):
            pids = [int(p) for p in pids]
            for pid in pids:
                self._check_owner(shard, pid)
            self.pools[shard].load_group(pids)
        return on_load_group

    # ------------------------------------------------------------- device --
    def mode(self) -> str:
        """Resolved compute mode of the shards: cuda | torch | host."""
        return self.pools[0].mode()

    @property
    def device(self) -> Optional[torch.device]:
        """The primary device: shard 0's, where results are gathered
        (None in host mode)."""
        return self.pools[0].device

    # ----------------------------------------------------------- placement --
    def placement(self) -> Placement:
        self.store.packing                 # may repack: read before gen
        gen = self.store.pack_generation
        pl = self._placement_obj
        if pl is not None and pl.pack_generation == gen:
            return pl
        budget = None
        if self.placement_policy == "sharers":
            budget = max(0, int(self.replicate_frac
                                * self.capacity_per_shard))
        pl = make_placement(self.placement_policy, self.store,
                            self.num_shards, replicate_budget=budget)
        self._placement_obj = pl
        return pl

    def flush(self) -> None:
        """Store repacked: every shard slab, staging tail, and the
        placement itself refer to dead page ids."""
        for p in self.pools:
            p.flush()
        for d in self._staged:
            d.clear()
        self._placement_obj = None

    # ------------------------------------------------------------ failover --
    def fail_shard(self, shard: int) -> None:
        """Mark ``shard`` dead: its slab contents are gone (residency
        dropped, staged borrows cleared), the router stops choosing it,
        and pages it owned serve through the borrow-staging path from
        surviving owners' slabs or straight from the store.  Idempotent
        for an already-dead shard."""
        s = int(shard)
        if not 0 <= s < self.num_shards:
            raise ValueError(f"no shard {s} (have {self.num_shards})")
        if s in self.dead:
            return
        self.dead.add(s)
        self.failovers += 1
        # invalidate fires on_evict, so the slab slots free too — the
        # per-shard residency invariant holds through the failure
        self.buffer_pools[s].invalidate_resident()
        self._staged[s].clear()

    def revive_shard(self, shard: int) -> None:
        """Re-place a recovered shard back into the rotation.  It comes
        back *empty* (demand faulting refills it); routing sees it again
        immediately."""
        self.dead.discard(int(shard))

    def alive_shards(self) -> List[int]:
        return [s for s in range(self.num_shards) if s not in self.dead]

    # ------------------------------------------------------------- borrows --
    def staged(self, shard: int) -> Dict[int, int]:
        return self._staged[shard]

    def _copy_resident(self, shard: int, owner: int, pids: List[int],
                       st: Dict[int, int]) -> None:
        """Copy ``pids``, resident on ``owner``, into ``shard``'s staging
        tail at their staged slots: one gather from the owner's slab (its
        host mirror in host mode) and one tail write."""
        src = self.pools[owner]
        slots = np.asarray([src.slot_of[p] for p in pids], np.int64)
        rows = src.host_slab[slots] if src.mode() == "host" \
            else src.slab.index_select(0, src._put(slots))
        self.pools[shard].write_stage([st[p] for p in pids], rows)

    def stage_borrows(self, shard: int, pages, model
                      ) -> Optional[Tuple[Dict[int, int], int, int, int]]:
        """Stage ``pages`` (owned elsewhere) into ``shard``'s staging tail.

        **Coalesced across batches**: pages already staged on this shard
        by an earlier batch are *reused* (page bytes are immutable per
        packing), and stale staged entries the current batch doesn't need
        are dropped to free staging slots.

        **Batched within a batch**: new pages are grouped by owning
        shard; each owner's missing pages demand-fault through that
        owner's pool as ONE pinned group, each owner's resident rows copy
        into the tail with one gather, and the pages that come from the
        store go up in one copy.

        Returns ``(staged map, mirror_hits, owner_faults, reused)`` — the
        reference's counts and slots exactly — or None when the borrow
        set cannot fit the staging tail.  The borrow's seconds are
        charged by the caller (``ShardedWeightServer._borrow``)."""
        pages = sorted(set(int(p) for p in pages))
        st = self._staged[shard]
        if not pages:
            return dict(st), 0, 0, 0
        if len(pages) > self.borrow_capacity:
            st.clear()
            return None
        pl = self.placement()
        pset = set(pages)
        reused = [p for p in pages if p in st]
        new = [p for p in pages if p not in st]
        if new:
            # drop stale entries (not in this batch) to free their slots
            for p in [p for p in st if p not in pset]:
                del st[p]
            free = sorted(set(range(self.borrow_capacity)) - set(st.values()),
                          reverse=True)
            for pid in new:
                st[pid] = free.pop()
            # owner resolution + resident hits FIRST: their bytes are
            # copied before any fault below can evict them (in stream
            # order on the card)
            fault_by_owner: Dict[int, List[int]] = {}
            hit_by_owner: Dict[int, List[int]] = {}
            orphaned: List[int] = []       # every owner dead: store-direct
            hits = 0
            for pid in new:
                owners = pl.shards_of(pid)
                assert shard not in owners, \
                    f"page {pid} is owned by shard {shard}; not a borrow"
                alive = [o for o in owners if o not in self.dead]
                owner = next((o for o in alive
                              if pid in self.pools[o].slot_of), None)
                if owner is not None:
                    hit_by_owner.setdefault(owner, []).append(pid)
                    hits += 1
                elif alive:
                    fault_by_owner.setdefault(alive[0], []).append(pid)
                else:
                    orphaned.append(pid)
            for owner, pids in hit_by_owner.items():
                self._copy_resident(shard, owner, pids, st)
            faults = 0
            from_store: List[int] = []
            for owner, pids in sorted(fault_by_owner.items()):
                bp = self.buffer_pools[owner]
                with bp.deferred_loads():        # ONE transfer on the owner
                    for pid in pids:
                        bp.access(model, pid)
                        faults += 1
                # copy after the flush; a page the fault window itself
                # evicted again (thrashing owner pool) sources its —
                # identical — bytes straight from the store instead
                live = [p for p in pids if p in self.pools[owner].slot_of]
                if live:
                    self._copy_resident(shard, owner, live, st)
                from_store += [p for p in pids
                               if p not in self.pools[owner].slot_of]
            if orphaned:
                # failover tail: every owning shard is dead, so the
                # bytes come straight from the storage tier (counted as
                # store faults — the caller charges them accordingly)
                self.store.fault_pages(orphaned)
                from_store += orphaned
                faults += len(orphaned)
            if from_store:
                self._upload_from_store(shard, from_store, st)
        else:
            hits = faults = 0
        self.borrow_mirror_hits += hits
        self.borrow_store_faults += faults
        self.borrow_coalesced += len(reused)
        return dict(st), hits, faults, len(reused)

    def _upload_from_store(self, shard: int, pids: List[int],
                           st: Dict[int, int]) -> None:
        """The store's bytes of ``pids`` into ``shard``'s staging tail, in
        one upload.  The caller charges the fetch."""
        stack = np.stack([self.store.page_array(p, dtype=np.float32)
                          for p in pids])
        pool = self.pools[shard]
        rows = stack if pool.mode() == "host" else pool.transfer.upload(stack)[0]
        pool.write_stage([st[p] for p in pids], rows)

    # --------------------------------------------------------------- remap --
    def remap(self, shard: int, vt: VirtualTensor,
              key: Optional[Tuple[str, str]] = None, strict: bool = True
              ) -> Tuple[Optional[np.ndarray], bool]:
        """Extended slot remap for ``shard``: owned pages resolve to the
        shard's slab slots, staged borrows to ``capacity + stage_idx``.
        Returns ``(dev_map, uses_extra)``; a map that touches staged
        slots is rebuilt per batch (staging indices are transient), maps
        with no staged pages delegate to the shard pool's cached remap.
        """
        staged = self._staged[shard]
        pool = self.pools[shard]
        touched = [p for p in vt.page_ids if p in staged] if staged else []
        if not touched:
            return pool.remap(vt, key=key, strict=strict), False
        l = pool.blocks_per_page
        ext = pool._page_to_slot.copy()
        for pid in touched:
            if ext[pid] < 0:
                ext[pid] = pool.capacity + staged[pid]
        slots = ext[vt.block_map // l]
        holes = slots < 0
        dev_map = np.where(holes, -1,
                           slots * l + vt.block_map % l).astype(np.int32)
        if strict and holes.any():
            return None, True
        return dev_map, True

    # ------------------------------------------------------------- compute --
    def _unpin(self, shard: int, out):
        """Results computed on a shard's device come back to the primary
        device (shard 0's), so downstream consumers (head matmuls, decode
        steps) can mix results from different shards.  The identity when
        every shard shares that device, and on host-mode arrays."""
        if isinstance(out, torch.Tensor) and self.device is not None:
            return out.to(self.device)
        return out

    def _count_tail_read(self, op: str, uses_extra: bool) -> None:
        if uses_extra:
            self.tail_reads[op] += 1

    def gather_rows(self, shard: int, dev_map, grid, rows, pad: bool = False,
                    uses_extra: bool = False):
        self._count_tail_read("gather_rows", uses_extra)
        return self._unpin(shard, self.pools[shard].gather_rows(
            dev_map, grid, rows, pad=pad))

    def virtual_matmul(self, shard: int, dev_map, grid, x,
                       uses_extra: bool = False):
        self._count_tail_read("virtual_matmul", uses_extra)
        return self._unpin(shard, self.pools[shard].virtual_matmul(
            dev_map, grid, x))

    def unblock(self, shard: int, dev_map, grid, uses_extra: bool = False):
        self._count_tail_read("unblock", uses_extra)
        return self._unpin(shard, self.pools[shard].unblock(
            dev_map, grid))

    # ----------------------------------------------------------- reporting --
    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self.pools)

    @property
    def loads(self) -> int:
        return sum(p.loads for p in self.pools)

    @property
    def evicts(self) -> int:
        return sum(p.evicts for p in self.pools)

    def resident_pages(self) -> Set[int]:
        out: Set[int] = set()
        for p in self.pools:
            out |= p.resident_pages()
        return out

    def stacked_slab(self, mesh=None) -> Optional[torch.Tensor]:
        """The per-shard slabs' resident rows stacked to ``[num_shards,
        capacity, blocks_per_page, bh, bw]`` on the primary device (the
        staging tails are not part of the pool); None in host mode.  With
        a serving ``mesh`` (``launch.mesh.make_shard_mesh``) the stack is
        a DTensor on it, laid out by ``slab_spec`` sanitized for its
        shape (the shard dim over the ``shard`` axis where it divides,
        else replicated): the reference's ``NamedSharding`` view.  A
        single controller's mesh has one device, so the local tensor is
        the whole stack."""
        if any(p.slab is None for p in self.pools):
            return None
        stacked = torch.stack([p.slab[:p.capacity].to(self.device)
                               for p in self.pools])
        if mesh is None:
            return stacked
        from torch.distributed.tensor import distribute_tensor

        from ..distributed.sharding import slab_sharding
        return distribute_tensor(stacked.to(mesh.device_type), mesh,
                                 slab_sharding(mesh, tuple(stacked.shape)))

    def check_invariants(self) -> None:
        """Per-shard residency invariant (slab == pool members, slots
        consistent) plus the global placement invariant (no page
        resident on a shard placement didn't assign it).  Raises
        AssertionError on violation."""
        pl = self.placement()
        for s in range(self.num_shards):
            dev, bp = self.pools[s], self.buffer_pools[s]
            assert bp.resident_pages() == dev.resident_pages(), \
                f"shard {s}: pool resident set != slab occupancy"
            occ = dev.occupied_slots()
            assert len(occ) == len(dev.slot_of), f"shard {s}: slot aliasing"
            assert len(occ) + len(dev._free) == dev.capacity
            for pid in dev.resident_pages():
                assert s in pl.shards_of(pid), \
                    f"page {pid} resident on shard {s}, owned by " \
                    f"{pl.shards_of(pid)}"
        for s in self.dead:
            assert not self.pools[s].resident_pages(), \
                f"dead shard {s} still holds resident pages"
            assert not self._staged[s], \
                f"dead shard {s} still has staged borrows"


class _ShardedPoolView:
    """Union read-view over the per-shard buffer pools — quacks enough
    like one :class:`BufferPool` for the engines (scheduler residency),
    benchmarks (hit stats) and the λ-prefetcher (placement-routed
    admission)."""

    def __init__(self, sharded: ShardedPagePool):
        self._s = sharded

    def resident_pages(self) -> Set[int]:
        out: Set[int] = set()
        for bp in self._s.buffer_pools:
            out |= bp.resident_pages()
        return out

    def _sum(self, attr: str) -> int:
        return sum(getattr(bp, attr) for bp in self._s.buffer_pools)

    @property
    def hits(self) -> int:
        return self._sum("hits")

    @property
    def misses(self) -> int:
        return self._sum("misses")

    @property
    def evictions(self) -> int:
        return self._sum("evictions")

    @property
    def prefetches(self) -> int:
        return self._sum("prefetches")

    @property
    def prefetch_declined(self) -> int:
        return self._sum("prefetch_declined")

    @property
    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def reset_stats(self) -> None:
        for bp in self._s.buffer_pools:
            bp.reset_stats()

    @contextlib.contextmanager
    def deferred_loads(self):
        """Batch physical loads across every shard pool: whichever shard
        a page routes to, its loads flush as one grouped transfer per
        shard on exit (the prefetcher wraps its issuing loop in this)."""
        with contextlib.ExitStack() as stack:
            for bp in self._s.buffer_pools:
                stack.enter_context(bp.deferred_loads())
            yield

    def model_rates(self) -> Dict:
        """Per-model λ estimates summed over shards (each shard sees a
        slice of the model's demand stream)."""
        out: Dict = {}
        for bp in self._s.buffer_pools:
            for m, lam in bp.model_rates().items():
                out[m] = out.get(m, 0.0) + lam
        return out

    def prefetch(self, model, page) -> bool:
        """Placement-routed speculative admission: a page prefetches into
        its primary owning shard (never a non-owner), declined when
        already resident on any owner."""
        pid = int(page)
        pl = self._s.placement()
        owners = [o for o in pl.shards_of(pid) if o not in self._s.dead]
        if not owners:                    # every owner failed: no home
            return False
        if any(pid in self._s.pools[o].slot_of for o in owners):
            return False
        return self._s.buffer_pools[owners[0]].prefetch(model, pid)


# ----------------------------------------------------------- sharded server --
class ShardedWeightServer(WeightServer):
    """Page-granular weight access across a sharded device page pool.

    Drop-in for ``WeightServer(backend="device")``: the engines call the
    same ``access_pages`` / ``access_pages_grouped`` / ``device_*``
    surface.  Each batch is routed to the shard owning the majority of
    its cover pages; owned pages fault through that shard's buffer pool
    (storage-charged), minority pages are borrowed from their owning
    shards into the executing shard's staging tail (interconnect-charged)
    — both on the fetch channel.

    ``capacity_pages`` is PER SHARD (one device's slab), so adding shards
    adds aggregate capacity.  ``kernel_mode`` and ``devices`` go to every
    shard's :class:`DevicePagePool`; in cuda mode a page group or a borrow
    set that does not fit raises (:meth:`host_fallback_allowed`).
    """

    def __init__(self, store: ModelStore, capacity_pages: int,
                 policy: str = "optimized_mru",
                 storage: Optional[StorageModel] = None,
                 shards: int = 2, placement: str = "sharers",
                 kernel_mode: str = "auto",
                 interconnect: Optional[StorageModel] = None,
                 replicate_frac: float = 0.5,
                 borrow_capacity: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 transfer: str = "grouped",
                 charge_transfer: bool = False,
                 hbm: Optional[StorageModel] = None,
                 balance_replicas: bool = True):
        self.store = store
        self.backend = "device"
        self.transfer = transfer
        self.charge_transfer = charge_transfer
        self.hbm_channel = hbm
        self.sharded = ShardedPagePool(
            store, shards, capacity_pages, placement=placement,
            policy=policy, kernel_mode=kernel_mode,
            replicate_frac=replicate_frac, borrow_capacity=borrow_capacity,
            devices=devices, transfer=transfer)
        self.device_pool = self.sharded        # aggregate reporting view
        self.pool = self.sharded.view          # union view for the engines
        self.router = ShardRouter(self.sharded.placement,
                                  balance_replicas=balance_replicas,
                                  dead_fn=lambda: self.sharded.dead)
        self.storage = storage or StorageModel("ssd", channel="storage")
        # Borrow transfers move slab bytes between shards, not through
        # the storage tier: charged at host-DRAM/interconnect rates
        # unless told otherwise.
        self.interconnect = interconnect or StorageModel("dram", channel="interconnect")
        bh, bw = store.cfg.dedup.block_shape
        self.page_bytes = store.cfg.blocks_per_page * bh * bw \
            * store.native_page_dtype().itemsize
        self.stats = ServeStats()
        self._pool_arr: Optional[np.ndarray] = None
        self._pool_gen = store.pack_generation
        self._route: Optional[RouteDecision] = None
        self._fault_snap = store.fault_stats.snapshot()

    @property
    def num_shards(self) -> int:
        return self.sharded.num_shards

    def shard_resident_pages(self, shard: Optional[int] = None):
        """Resident page ids of ONE shard's pool (``None``: the union
        view).  The frontend's admission probe scores a candidate batch
        against the residency of the shard the router would place it on
        — not the union — so cross-shard dedup affinity is never
        overcounted."""
        if shard is None:
            return self.pool.resident_pages()
        return self.sharded.buffer_pools[int(shard)].resident_pages()

    # ------------------------------------------------------------- failover --
    def fail_shard(self, shard: int) -> None:
        """Fail a shard mid-run: traffic re-routes to survivors, its
        owned pages serve via borrow staging (a surviving owner's slab or
        the store), and the cached route is dropped if it pointed
        there."""
        self.sharded.fail_shard(shard)
        self.stats.failovers = self.sharded.failovers
        if self._route is not None and self._route.shard == int(shard):
            self._route = None

    def revive_shard(self, shard: int) -> None:
        self.sharded.revive_shard(shard)

    # -------------------------------------------------------- invalidation --
    def _sync_store(self) -> None:
        self.store.packing                     # force repack if stale
        if self._pool_gen == self.store.pack_generation:
            return
        for bp in self.sharded.buffer_pools:
            bp.invalidate_resident()           # fires on_evict -> shard slab
        self.sharded.flush()
        sharers, locality = self.store.page_metadata()
        for bp in self.sharded.buffer_pools:
            bp.page_sharers = sharers
            bp.page_locality = locality
            bp.meta.clear()
        self._pool_arr = None
        self._route = None
        self._pool_gen = self.store.pack_generation

    # -------------------------------------------------------------- routing --
    def _resolve_route(self, pages) -> RouteDecision:
        """The device compute paths re-derive their routing instead of
        trusting ambient state: a page subset of the last *accessed*
        batch reuses that batch's shard (so an LM model-switch assembles
        every tensor on the one shard its pages were faulted/staged on);
        anything else recomputes the deterministic decision."""
        pl = self.sharded.placement()
        ps = set(int(p) for p in pages)
        r = self._route
        if r is not None and r.pack_generation == pl.pack_generation \
                and r.shard not in self.sharded.dead \
                and ps <= r.page_set:
            owned, borrowed = self.router.split(ps, r.shard)
            return RouteDecision(r.shard, tuple(owned), tuple(borrowed),
                                 pl.pack_generation)
        return self.router.route(ps, record=False)

    # --------------------------------------------------------------- access --
    def _record_route(self, route: RouteDecision) -> None:
        self._route = route
        self.stats.shard_batches[route.shard] = \
            self.stats.shard_batches.get(route.shard, 0) + 1

    def _access_owned(self, model: str, route: RouteDecision) -> List[bool]:
        """The routed shard's owned pages, pinned as a group like the
        single-slab server's; a group the shard cannot hold raises in
        cuda mode and goes unpinned in the CPU modes."""
        bp = self.sharded.buffer_pools[route.shard]
        try:
            return bp.access_group(model, list(route.owned))
        except ValueError:
            if not self.host_fallback_allowed():
                raise
            return [bp.access(model, p) for p in route.owned]

    def access_pages(self, model: str, page_ids) -> float:
        """Serial access: owned pages one at a time through the routed
        shard's pool (every miss pays its own seek), then the borrow
        staging; returns total virtual seconds."""
        self._sync_store()
        route = self.router.route(list(page_ids))
        self._record_route(route)
        flags = self._access_owned(model, route)
        t = 0.0
        misses = 0
        for hit in flags:
            if not hit:
                t += self.storage.fetch_seconds(self.page_bytes)
                misses += 1
                self.stats.pages_fetched += 1
        t += self._charge_hbm(misses)
        t += self._borrow(route, model, grouped=False)
        t += self._charge_faults()
        self.stats.fetch_seconds += t
        return t

    def access_pages_grouped(self, model: str, page_ids) -> float:
        """Grouped access: the routed shard's owned misses share one
        seek (pinned as a group so same-batch faults cannot tear the
        shard slab), borrows ride one grouped fetch."""
        self._sync_store()
        pages = list(page_ids)
        with get_tracer().span("fault_group", kind="storage", model=model,
                               pages=len(pages)) as sp:
            self.store.fault_pages(pages)
            route = self.router.route(pages)
            self._record_route(route)
            flags = self._access_owned(model, route)
            misses = sum(not h for h in flags)
            t = self.storage.fetch_group_seconds(self.page_bytes, misses)
            t += self._charge_hbm(misses)
            self.stats.pages_fetched += misses
            t += self._borrow(route, model, grouped=True)
            t += self._charge_faults()
            sp.set(shard=route.shard, misses=misses,
                   borrowed=len(route.borrowed), seconds=t)
        self.stats.fetch_seconds += t
        return t

    def _borrow(self, route: RouteDecision, model: str,
                grouped: bool) -> float:
        """Run the borrow protocol for a routed batch's minority pages;
        returns the virtual seconds charged to the fetch channel
        (owner-side storage faults + shard->tail interconnect copies).
        A borrow set the staging tail cannot hold raises in cuda mode."""
        tr = get_tracer()
        with tr.span("borrow_stage", kind="borrow", shard=route.shard,
                     pages=len(route.borrowed)) as sp:
            res = self.sharded.stage_borrows(route.shard, route.borrowed,
                                             model)
            if res is not None:
                _, mh, of, ru = res
                sp.set(mirror_hits=mh, owner_faults=of, reused=ru)
            else:
                sp.set(refused=True)
        if res is None:
            if not self.host_fallback_allowed():
                raise RuntimeError(
                    f"shard {route.shard}: {len(route.borrowed)} borrowed "
                    f"pages exceed the staging tail of "
                    f"{self.sharded.borrow_capacity}, and cuda mode does not "
                    f"fall back to the host")
            # Oversized borrow set in a CPU mode: compute falls back to
            # the host — which still has to READ those pages, so charge
            # them as storage misses.
            n = len(route.borrowed)
            if grouped:
                t = self.storage.fetch_group_seconds(self.page_bytes, n)
            else:
                t = n * self.storage.fetch_seconds(self.page_bytes)
            self.stats.pages_fetched += n
            self.stats.borrow_seconds += t
            return t
        staged, mirror_hits, owner_faults, reused = res
        # coalesced borrows (already staged by a previous same-shard
        # batch) move no bytes and pay no interconnect charge — only the
        # freshly staged pages do
        n = mirror_hits + owner_faults
        self.stats.borrow_coalesced += reused
        if not n:
            return 0.0
        if grouped:
            t = self.storage.fetch_group_seconds(self.page_bytes,
                                                 owner_faults) \
                + self.interconnect.fetch_group_seconds(self.page_bytes, n)
        else:
            t = owner_faults * self.storage.fetch_seconds(self.page_bytes) \
                + n * self.interconnect.fetch_seconds(self.page_bytes)
        self.stats.pages_fetched += owner_faults
        self.stats.borrow_pages += n
        self.stats.borrow_seconds += t
        self.stats.borrow_mirror_hits += mirror_hits
        self.stats.borrow_store_faults += owner_faults
        return t

    # ---------------------------------------------- transfer double buffer --
    def _hbm(self) -> StorageModel:
        """Host<->device channel calibrated from shard 0's transfer
        engine (the shards' slabs are identical in shape)."""
        if self.hbm_channel is None:
            self.hbm_channel = self.sharded.pools[0].transfer.storage_model()
        return self.hbm_channel

    def prestage(self, page_ids) -> None:
        """Stage the next batch's *owned* missing pages on the shard it
        will route to (borrowed pages move through the staging tail, not
        the transfer engine, so they are not prestaged)."""
        if self.transfer != "grouped":
            return
        self._sync_store()
        route = self.router.route(list(page_ids), record=False)
        if route.owned:
            self.sharded.pools[route.shard].transfer.stage(route.owned)

    def transfer_snapshot(self):
        """Transfer-engine counters summed over the shards, each shard's
        CUDA-event timings resolved first."""
        out = {"seconds": 0.0, "pages": 0, "bytes": 0, "groups": 0,
               "overlapped_bytes": 0}
        for p in self.sharded.pools:
            p.transfer.resolve()
            s = p.transfer.stats
            out["seconds"] += s.seconds
            out["pages"] += s.pages
            out["bytes"] += s.bytes
            out["groups"] += s.groups
            out["overlapped_bytes"] += s.overlapped_bytes
        return out

    # ------------------------------------------------- device (HBM) path --
    def device_gather_rows(self, model: str, tensor: str, rows,
                           pad: bool = False, pages=None):
        self._sync_store()
        vt = self.store.virtual_tensor(model, tensor)
        route = self._resolve_route(pages if pages is not None
                                    else vt.page_ids)
        s = route.shard
        staged = self.sharded.staged(s)
        if any(p not in staged for p in route.borrowed):
            return None
        if not self.sharded.pools[s].pages_resident(route.owned):
            return None
        dev_map, uses_extra = self.sharded.remap(
            s, vt, key=(model, tensor), strict=pages is None)
        if dev_map is None:
            return None
        return self.sharded.gather_rows(s, dev_map, vt.grid, rows, pad=pad,
                                        uses_extra=uses_extra)

    def _device_map_sharded(self, model: str, tensor: str):
        vt = self.store.virtual_tensor(model, tensor)
        route = self._resolve_route(vt.page_ids)
        s = route.shard
        staged = self.sharded.staged(s)
        if any(p not in staged for p in route.borrowed) \
                or not self.sharded.pools[s].pages_resident(route.owned):
            return vt, s, None, False
        dev_map, uses_extra = self.sharded.remap(s, vt,
                                                 key=(model, tensor),
                                                 strict=True)
        return vt, s, dev_map, uses_extra

    def device_matmul(self, model: str, tensor: str, x):
        self._sync_store()
        vt, s, dev_map, uses_extra = self._device_map_sharded(model, tensor)
        if dev_map is None:
            return None
        return self.sharded.virtual_matmul(s, dev_map, vt.grid, x,
                                           uses_extra=uses_extra)

    def device_tensor(self, model: str, tensor: str):
        self._sync_store()
        vt, s, dev_map, uses_extra = self._device_map_sharded(model, tensor)
        if dev_map is None:
            return None
        return self.sharded.unblock(s, dev_map, vt.grid,
                                    uses_extra=uses_extra)
