"""Page prefetcher: queue-aware lookahead + λ-driven speculation.

Two planning tiers, consumed in order:

1. **Queue-aware lookahead** (deterministic): the scheduler exposes the
   pending batches' page working sets (``BatchScheduler.
   pending_batches``, estimated at submit time), so the prefetcher
   *knows* what is about to be demanded.  Those pages — deduped against
   the pool's resident set and gated on the packing generation they
   were minted under — are pulled first.
2. **λ-driven speculation** (paper Eq. 2): the buffer pool estimates
   each model's arrival rate online; the hottest models' missing pages
   are most likely to be demanded next, so any *remaining* idle budget
   goes to them.

Either way the virtual storage time lands on the fetch channel, where
the engine's double-buffered timeline overlaps it with compute.
Admission goes through :meth:`BufferPool.prefetch`, which never counts
a hit/miss (demand-traffic stats stay clean) and refuses to displace
pages the eviction policy rates hotter.

``PrefetchStats.lookahead_hits`` is the proof stat: pages issued by the
lookahead tier that a later demand access actually hit (the engines
report each batch's demand set via :meth:`Prefetcher.note_demand`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["PrefetchStats", "Prefetcher"]


@dataclasses.dataclass
class PrefetchStats:
    """Prefetcher proof counters (issued/declined/lookahead hits)."""
    issued: int = 0            # pages actually loaded ahead of demand
    declined: int = 0          # offers the pool's admission refused
    seconds: float = 0.0       # virtual storage time spent prefetching
    lookahead_issued: int = 0  # of issued: planned from queued batches
    lookahead_hits: int = 0    # lookahead pages a demand access then hit


class Prefetcher:
    """Plans and issues page prefetches for a :class:`WeightServer`.

    ``hot_models``: how many of the highest-lambda models to prefetch for.
    ``max_pages_per_step``: page budget per :meth:`step` call (one call
    per served batch keeps the fetch channel from drowning in
    speculation).
    ``lookahead``: how many queued batches to scan for the queue-aware
    tier (0 disables it).  The engines attach their scheduler via
    :meth:`attach_scheduler`; without one the prefetcher is pure-λ, the
    pre-lookahead behavior.
    """

    def __init__(self, server, hot_models: int = 2,
                 max_pages_per_step: int = 4, lookahead: int = 8):
        self.server = server
        self.hot_models = hot_models
        self.max_pages_per_step = max_pages_per_step
        self.lookahead = lookahead
        self.scheduler = None
        self._rate_fn = None
        self.stats = PrefetchStats()
        self._gen = None
        self._plan_lookahead: Set[int] = set()   # lookahead pages, last plan
        self._outstanding: Set[int] = set()      # issued, not yet demanded
        self._refresh()

    def attach_scheduler(self, scheduler) -> None:
        """Give the prefetcher visibility into the pending queue (the
        engines call this at construction)."""
        self.scheduler = scheduler

    def attach_rates(self, rate_fn) -> None:
        """Override the λ source with *observed* arrival rates: a
        zero-arg callable returning ``{model: requests/s}`` (the
        serving frontend attaches its EMA over request arrivals on the
        virtual clock).  The pool's access-count rates — a trailing
        proxy measured after batching — are then only the fallback
        while the feed is empty, so the speculative tier re-targets as
        soon as the arrival mix shifts instead of waiting for the new
        mix to dominate the access history."""
        self._rate_fn = rate_fn

    def _refresh(self) -> None:
        """(Re)derive the per-model page working sets from the store's
        *current* packing.  Keyed on ``pack_generation`` so a model
        update/repack mid-serve can never leave the prefetcher pulling
        page ids from the previous packing (which now name other bytes —
        or nothing)."""
        self.server.store.packing                # force repack if stale
        gen = self.server.store.pack_generation
        if gen == self._gen:
            return
        # model -> its page working set, from the store's packing
        self._model_pages: Dict[str, List[int]] = {
            m: self.server.store.model_pages(m)
            for m in self.server.store.dedup.models}
        counts = self.server.store.page_sharer_counts()
        self._n_sharers = {p: int(c) for p, c in enumerate(counts)}
        self._outstanding.clear()                # stale page ids
        self._gen = gen

    # -- planning ------------------------------------------------------------
    def plan(self) -> List[Tuple[str, int]]:
        """(model, page) prefetch candidates: queued batches' pages
        first (arrival order), then the λ tier — hottest model first,
        most-shared pages first within a model (they serve several
        queues)."""
        self._refresh()
        resident = self.server.pool.resident_pages()
        out: List[Tuple[str, int]] = []
        seen = set()
        self._plan_lookahead = set()
        # tier 1: what the queue says is coming
        if self.scheduler is not None and self.lookahead > 0:
            gen = self.server.store.pack_generation
            for b in self.scheduler.pending_batches()[: self.lookahead]:
                if b.pages is None or b.pages_gen != gen:
                    continue                     # stale or unknown set
                for p in sorted(b.pages):
                    if p in resident or p in seen:
                        continue
                    out.append((b.model, p))
                    seen.add(p)
                    self._plan_lookahead.add(p)
                    if len(out) >= self.max_pages_per_step:
                        return out
        # tier 2: λ speculation with whatever budget remains; observed
        # arrival rates (frontend feed) beat the pool's access-count
        # proxy whenever the feed has seen traffic
        rates = self._rate_fn() if self._rate_fn is not None else {}
        if not rates:
            rates = self.server.pool.model_rates()
        hot = sorted(rates, key=rates.get, reverse=True)[: self.hot_models]
        for m in hot:
            missing = [p for p in self._model_pages.get(m, ())
                       if p not in resident and p not in seen]
            missing.sort(key=lambda p: (-self._n_sharers.get(p, 1), p))
            for p in missing:
                out.append((m, p))
                seen.add(p)
                if len(out) >= self.max_pages_per_step:
                    return out
        return out

    # -- accounting ----------------------------------------------------------
    def note_demand(self, pages) -> None:
        """The engines report each batch's demand page set here; pages
        the lookahead tier issued that now get demanded are the
        lookahead *hits* — the stat proving the queue-aware tier pulled
        the right pages."""
        if not self._outstanding:
            return
        hit = self._outstanding.intersection(int(p) for p in pages)
        if hit:
            self.stats.lookahead_hits += len(hit)
            self._outstanding -= hit

    # -- execution -----------------------------------------------------------
    def step(self, budget_s: Optional[float] = None) -> float:
        """Issue one planning round of prefetches; returns the virtual
        storage seconds consumed (the engine charges them to the fetch
        channel, overlapped with compute).

        ``budget_s`` caps the storage time spent.  The *actual* (jittered)
        cost is accumulated page by page and issuing stops as soon as the
        next expected transfer would overrun, so a slow draw can exceed
        the budget by at most one in-flight page transfer — the engine
        passes the fetch channel's idle headroom, keeping speculation off
        the demand path.  The round still amortizes like ONE grouped
        fetch: a single seek, then seek-less per-page transfers —
        page-at-a-time prefetching would pay a seek per page and lose to
        the demand path's own group amortization.

        The *physical* reads group the same way the accounting does:
        admission runs inside the pool's ``deferred_loads`` window, so
        every page the policy admits this round flushes as ONE grouped
        backend read + ONE host->HBM transfer (``on_load_group``) —
        never a per-page ``store.page_array`` -> ``get_pages`` round
        trip per admitted page."""
        from ..obs import get_tracer
        storage = self.server.storage
        base_transfer = self.server.page_bytes / storage.bw
        issued = 0
        t = 0.0
        deferred = getattr(self.server.pool, "deferred_loads",
                           contextlib.nullcontext)
        with get_tracer().span("prefetch_step", kind="policy",
                               budget_s=budget_s) as sp:
            with deferred():
                for model, page in self.plan():
                    cost_floor = (storage.seek if issued == 0 else 0.0) \
                        + base_transfer
                    if budget_s is not None and t + cost_floor > budget_s:
                        break
                    if self.server.pool.prefetch(model, page):
                        if issued == 0:
                            t += storage.fetch_seconds(
                                self.server.page_bytes)
                        else:
                            t += storage.transfer_seconds(
                                self.server.page_bytes)
                        issued += 1
                        if page in self._plan_lookahead:
                            self.stats.lookahead_issued += 1
                            self._outstanding.add(int(page))
                    else:
                        self.stats.declined += 1
            sp.set(issued=issued, seconds=t,
                   lookahead_hits=self.stats.lookahead_hits)
        self.stats.issued += issued
        self.stats.seconds += t
        return t
