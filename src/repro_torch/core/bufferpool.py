"""Dedup-aware buffer-pool management (paper Sec. 6).

The pool holds a bounded number of pages.  Baseline policies: LRU / MRU /
LFU.  Locality-set policies (Pangea, refs [82, 83]) group pages into
locality sets, each with its own internal policy; the victim *set* is the
one whose next page-to-evict has the lowest expected eviction cost

    cost = c_w + p_reuse * c_r                                     (Eq. 1)

The paper's contribution ("Optimized-M/L"): model page accesses as
superposed Poisson processes of the models *sharing* the page, so

    p_reuse = 1 - exp(-sum_{m_i in sharers} lambda_i * t)          (Eq. 2)

giving shared pages higher retention priority.  ``lambda_i`` is estimated
online from each model's request stream (EMA of instantaneous rate) — in
the serving engine these are the per-model queue rates.

The pool is a policy simulator by default; ``on_load``/``on_evict``
callbacks let the serving engine attach real host<->HBM page movement
(the TPU adaptation of disk<->DRAM paging, see DESIGN.md §2).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import OrderedDict, defaultdict
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Set

from ..obs import get_tracer

PageId = Hashable
ModelId = Hashable

POLICIES = ("lru", "mru", "lfu",
            "locality_lru", "locality_mru",
            "optimized_lru", "optimized_mru")


@dataclasses.dataclass
class PoolConfig:
    """Eviction-policy parameters (paper Eq. 1/Eq. 2 constants)."""
    capacity_pages: int
    policy: str = "optimized_mru"
    c_w: float = 0.0        # weights are read-only -> no write-back cost
    c_r: float = 1.0
    horizon_t: float = 8.0  # "t time ticks" in Eq. 2
    rate_ema: float = 0.2   # EMA factor for lambda estimation

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")


@dataclasses.dataclass
class _PageMeta:
    last_tick: int = -1
    freq: int = 0
    locality_set: Hashable = None
    sharers: frozenset = frozenset()


class BufferPool:
    """Page residency policy simulator: tracks hits/misses, arrival
    rates and eviction order (Eq. 1/Eq. 2), driving the physical tiers
    through ``on_load`` / ``on_evict`` / ``on_load_group`` callbacks."""

    def __init__(self, cfg: PoolConfig,
                 page_sharers: Optional[Dict[PageId, Iterable[ModelId]]] = None,
                 page_locality: Optional[Dict[PageId, Hashable]] = None,
                 on_load: Optional[Callable[[PageId], None]] = None,
                 on_evict: Optional[Callable[[PageId], None]] = None,
                 on_load_group: Optional[Callable[[List[PageId]],
                                                  None]] = None):
        self.cfg = cfg
        self.meta: Dict[PageId, _PageMeta] = {}
        self.resident: "OrderedDict[PageId, None]" = OrderedDict()
        self.page_sharers = {p: frozenset(ms)
                             for p, ms in (page_sharers or {}).items()}
        self.page_locality = dict(page_locality or {})
        self.on_load = on_load
        self.on_evict = on_evict
        # Grouped backing-tier attachment: inside a deferred_loads()
        # window every miss's physical load is collected and flushed as
        # ONE on_load_group call (e.g. a single batched host->HBM
        # transfer) instead of per-page on_load round trips.  When only
        # on_load is attached the flush falls back to per-page calls, so
        # the per-page path is always preserved.
        self.on_load_group = on_load_group
        self._load_batch: Optional[List[PageId]] = None
        self.tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetches = 0          # pages admitted by prefetch()
        self.prefetch_declined = 0   # prefetch offers the policy refused
        self._lambda: Dict[ModelId, float] = defaultdict(float)
        self._last_access: Dict[ModelId, int] = {}
        self._set_lambda: Dict[Hashable, float] = defaultdict(float)
        self._set_last: Dict[Hashable, int] = {}
        self._pinned: Set[PageId] = set()

    # ------------------------------------------------------------- metrics --
    @property
    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
        self.prefetches = self.prefetch_declined = 0

    def model_rates(self) -> Dict[ModelId, float]:
        """Per-model arrival-rate estimates (the lambda_i of Eq. 2), as
        maintained online from the demand access stream.  The serving
        prefetcher keys its model-hotness ranking off these."""
        return dict(self._lambda)

    def resident_pages(self) -> Set[PageId]:
        return set(self.resident)

    def invalidate_resident(self) -> None:
        """Drop every resident page *without* charging evictions: the
        backing store was repacked, so page ids no longer name the same
        bytes.  ``on_evict`` still fires per page so an attached device
        slab frees its slots."""
        for page in list(self.resident):
            del self.resident[page]
            if self.on_evict:
                self.on_evict(page)

    # -------------------------------------------------------------- access --
    def _ensure_meta(self, model: ModelId, page: PageId) -> _PageMeta:
        m = self.meta.get(page)
        if m is None:
            m = self.meta[page] = _PageMeta(
                locality_set=self.page_locality.get(page, page),
                sharers=self.page_sharers.get(page, frozenset([model])))
        return m

    def access(self, model: ModelId, page: PageId) -> bool:
        """Record an access; returns True on hit.  Loads the page on miss,
        evicting per policy when over capacity."""
        self.tick += 1
        self._update_rate(model)
        m = self._ensure_meta(model, page)
        self._update_set_rate(m.locality_set)
        m.last_tick = self.tick
        m.freq += 1

        if page in self.resident:
            self.hits += 1
            self.resident.move_to_end(page)      # LRU order maintenance
            return True
        self.misses += 1
        while len(self.resident) >= self.cfg.capacity_pages:
            self._evict_one()
        self.resident[page] = None
        try:
            self._note_load(page)
        except BaseException:
            # failed physical load: un-admit (no on_evict — no slot held)
            self.resident.pop(page, None)
            raise
        return False

    def _note_load(self, page: PageId) -> None:
        """Fire (or defer) the physical load for a freshly admitted page:
        inside a deferred_loads() window the page joins the batch flushed
        as one on_load_group; otherwise the per-page on_load fires."""
        if self._load_batch is not None:
            self._load_batch.append(page)
        elif self.on_load:
            self.on_load(page)

    def _flush_loads(self, batch: List[PageId]) -> None:
        # A page admitted and then evicted inside the same deferred
        # window must NOT be physically loaded: its eviction already
        # fired on_evict (a no-op slot free on an attached slab, since
        # the deferred load never claimed one), and loading it anyway
        # would create a ghost slab resident — or exhaust the slab's
        # free slots outright.  Flush only what is still resident.
        batch = [p for p in batch if p in self.resident]
        if not batch:
            return
        # Exception safety: if the physical load throws (e.g. a storage
        # fault past its retry budget), every page whose load did not
        # complete must be UN-admitted — it is resident in the policy's
        # books but holds no slab slot, a ghost that would serve garbage.
        # on_evict is deliberately not fired: the failed load never
        # claimed a slot, so there is nothing to free.
        if self.on_load_group is not None:
            try:
                self.on_load_group(list(batch))
            except BaseException:
                for page in batch:
                    self.resident.pop(page, None)
                raise
        elif self.on_load:
            for i, page in enumerate(batch):
                try:
                    self.on_load(page)
                except BaseException:
                    for p in batch[i:]:
                        self.resident.pop(p, None)
                    raise

    @contextlib.contextmanager
    def deferred_loads(self):
        """Collect every physical page load admitted inside the window
        and flush them as ONE grouped backing-tier transfer on exit
        (``on_load_group``; per-page ``on_load`` fallback preserved).
        Policy bookkeeping — hits/misses, evictions, recency — stays
        per-page and immediate; only the *physical* movement batches.
        Reentrant: a nested window joins the outer batch.  The flush
        runs even if the body raises, so the residency bookkeeping and
        the backing tier can never diverge."""
        if self._load_batch is not None:         # nested: join outer batch
            yield
            return
        self._load_batch = []
        try:
            yield
        finally:
            batch, self._load_batch = self._load_batch, None
            self._flush_loads(batch)

    def access_group(self, model: ModelId, pages: Iterable[PageId]
                     ) -> List[bool]:
        """Touch a batch's whole page working set atomically: the group is
        *pinned* for the duration, so a later miss in the same group can
        never evict an earlier member (which would tear a device-resident
        working set mid-batch), and the group's misses flush as ONE
        physical load (``deferred_loads``).  Raises ValueError when the
        group cannot possibly co-reside — callers fall back to unpinned
        access.  Returns the per-page hit flags."""
        pages = list(pages)
        if len(set(pages)) > self.cfg.capacity_pages:
            raise ValueError(
                f"group of {len(set(pages))} pages exceeds pool capacity "
                f"{self.cfg.capacity_pages}")
        self._pinned = set(pages)
        try:
            with get_tracer().span("pool_group", kind="pool", model=model,
                                   pages=len(pages)) as sp:
                with self.deferred_loads():
                    hits = [self.access(model, p) for p in pages]
                sp.set(hits=sum(hits))
                return hits
        finally:
            self._pinned = set()

    def _update_rate(self, model: ModelId) -> None:
        last = self._last_access.get(model)
        if last is not None:
            inst = 1.0 / max(1, self.tick - last)
            a = self.cfg.rate_ema
            self._lambda[model] = (1 - a) * self._lambda[model] + a * inst
        else:
            self._lambda[model] = self.cfg.rate_ema
        self._last_access[model] = self.tick

    def _update_set_rate(self, ls: Hashable) -> None:
        last = self._set_last.get(ls)
        if last is not None:
            inst = 1.0 / max(1, self.tick - last)
            a = self.cfg.rate_ema
            self._set_lambda[ls] = (1 - a) * self._set_lambda[ls] + a * inst
        else:
            self._set_lambda[ls] = self.cfg.rate_ema
        self._set_last[ls] = self.tick

    # ------------------------------------------------------------ eviction --
    def _p_reuse_eq2(self, page: PageId) -> float:
        """Eq. 2: superposed Poisson over the models sharing the page."""
        lam = sum(self._lambda.get(mid, 0.0)
                  for mid in self.meta[page].sharers)
        return 1.0 - math.exp(-lam * self.cfg.horizon_t)

    def _p_reuse_set(self, ls: Hashable) -> float:
        lam = self._set_lambda.get(ls, 0.0)
        return 1.0 - math.exp(-lam * self.cfg.horizon_t)

    def _cost(self, p_reuse: float) -> float:
        return self.cfg.c_w + p_reuse * self.cfg.c_r   # Eq. 1

    def _victim_in_set(self, pages, inner: str) -> PageId:
        # Recency order within the set, using resident OrderedDict order.
        ordered = [p for p in self.resident if p in pages]
        return ordered[-1] if inner == "mru" else ordered[0]

    def _pick_victim(self) -> PageId:
        pol = self.cfg.policy
        evictable = [p for p in self.resident if p not in self._pinned]
        if not evictable:
            raise RuntimeError("every resident page is pinned; "
                               "group exceeds usable capacity")
        if pol == "lru":
            return evictable[0]
        if pol == "mru":
            return evictable[-1]
        if pol == "lfu":
            return min(evictable, key=lambda p: (self.meta[p].freq,
                                                 self.meta[p].last_tick))
        inner = "mru" if pol.endswith("mru") else "lru"
        by_set: Dict[Hashable, Set[PageId]] = defaultdict(set)
        for p in evictable:
            by_set[self.meta[p].locality_set].add(p)
        best, best_cost = None, None
        for ls, pages in by_set.items():
            cand = self._victim_in_set(pages, inner)
            if pol.startswith("optimized"):
                pr = self._p_reuse_eq2(cand)     # Eq. 2 (shared-page aware)
            else:
                pr = self._p_reuse_set(ls)       # original locality-set
            cost = self._cost(pr)
            if best_cost is None or cost < best_cost:
                best, best_cost = cand, cost
        return best

    def _evict_one(self) -> None:
        victim = self._pick_victim()
        del self.resident[victim]
        self.evictions += 1
        if self.on_evict:
            self.on_evict(victim)

    # ----------------------------------------------------------- prefetch --
    def prefetch(self, model: ModelId, page: PageId) -> bool:
        """Speculatively bring ``page`` resident for ``model``.

        Prefetch-aware admission: unlike :meth:`access`, this records no
        hit/miss (those stats measure demand traffic only), does not
        advance the virtual clock, and does not bump the lambda_i
        estimates — a prefetch is the pool acting on its own prediction,
        not a model arrival.  When the pool is full, the page is admitted
        only if the policy's would-be victim has a *lower* Eq.-1 eviction
        cost than the prefetched page — prefetching must never displace a
        page the policy believes is hotter.

        Returns True iff the page was actually loaded (caller charges the
        storage fetch time); False if already resident or declined.
        """
        if page in self.resident:
            return False
        m = self._ensure_meta(model, page)
        while len(self.resident) >= self.cfg.capacity_pages:
            victim = self._pick_victim()
            if self._cost(self._p_reuse_eq2(victim)) \
                    >= self._cost(self._p_reuse_eq2(page)):
                self.prefetch_declined += 1
                return False
            self._evict_one()
        # Insert where the policy's victim selection looks FIRST (the MRU
        # end for *mru policies, the LRU end otherwise): a prefetched page
        # has not been *used* yet, so until a demand access promotes it,
        # it must stay the most evictable page — not the most protected.
        self.resident[page] = None
        self.resident.move_to_end(page,
                                  last=self.cfg.policy.endswith("mru"))
        m.last_tick = max(m.last_tick, 0)
        self.prefetches += 1
        try:
            self._note_load(page)
        except BaseException:
            self.resident.pop(page, None)
            raise
        return True


def run_trace(pool: BufferPool, trace) -> float:
    """Feed an iterable of (model, page) accesses; return hit ratio."""
    for model, page in trace:
        pool.access(model, page)
    return pool.hit_ratio
