"""Request router for sharded page-pool serving.

A batch's page working set rarely lives on one shard only; the router
sends the batch to the shard that *owns the majority of its cover
pages* (placement score = |pages ∩ shard's owned set|, ties to the
lowest shard id — except replication ties, which spread to the tied
shard with the lowest observed load so replicas actually absorb
traffic), and splits the set into:

  * ``owned``    — pages placement assigned to the chosen shard.  These
    are demand-faulted through that shard's own buffer pool (shard-local
    eviction), preserving the per-shard residency invariant.
  * ``borrowed`` — the minority pages owned elsewhere.  These are never
    loaded into the chosen shard's slab; the borrow protocol stages
    their bytes from an *owning* shard's host mirror (see
    ``shard_pool.ShardedPagePool.stage_borrows``), charged to the fetch
    channel like any other miss.

The router is pure placement arithmetic — set intersections over the
current :class:`~repro.serving.shard_pool.Placement` — so routing a
batch costs no weight or storage access, exactly like the affinity
scheduler's page-set scoring.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import get_tracer

__all__ = ["RouteDecision", "ShardRouter"]


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one batch runs, and how its page set splits there."""
    shard: int
    owned: Tuple[int, ...]       # pages the chosen shard owns (sorted)
    borrowed: Tuple[int, ...]    # minority pages owned elsewhere (sorted)
    pack_generation: int         # placement generation this was routed under

    @property
    def page_set(self) -> frozenset:
        return frozenset(self.owned) | frozenset(self.borrowed)


class ShardRouter:
    """Majority-cover routing over a placement provider.

    ``placement_fn`` returns the current
    :class:`~repro.serving.shard_pool.Placement` (rebuilt per pack
    generation), so routing decisions can never outlive the packing
    whose page ids they were made from.
    """

    def __init__(self, placement_fn: Callable,
                 balance_replicas: bool = True,
                 dead_fn: Optional[Callable] = None):
        self._placement = placement_fn
        # Failover awareness: ``dead_fn`` returns the currently-dead
        # shard ids (ShardedPagePool.dead).  Routing only ever considers
        # alive shards; a dead shard's owned pages fall into the batch's
        # ``borrowed`` minority and serve via the borrow-staging path
        # from surviving owners or the store.
        self._dead = dead_fn or (lambda: ())
        # Replica load balancing (ROADMAP): when several shards tie on
        # cover *because the batch's pages are replicated on them*, send
        # the batch to the least-loaded of the tied shards instead of
        # always the lowest id — replication only pays off if the
        # replicas actually absorb traffic.  ``rebalanced`` counts the
        # batches this moved off the default (lowest-id) shard.
        self.balance_replicas = balance_replicas
        self.rebalanced = 0
        # Routing-DECISION counters (what the router asked for).  What
        # actually executed — borrows staged, fallbacks, per-shard batch
        # totals — lives on the serving ServeStats; the two differ when
        # e.g. an oversized borrow set is refused staging.
        self.batches_per_shard: Dict[int, int] = {}
        self.borrowed_pages = 0

    def choose(self, pages, record: bool = True) -> int:
        """The shard owning the majority of ``pages``.  Ties go to the
        lowest shard id — except replication ties (the tied shards all
        hold replicas of the batch's shared pages), which go to the tied
        shard with the fewest batches routed so far, so replicated reads
        move off the hot shard.  ``record=False`` (advisory probes)
        never bumps the ``rebalanced`` proof counter."""
        pl = self._placement()
        dead = set(self._dead())
        alive = [s for s in range(pl.num_shards) if s not in dead]
        if not alive:
            raise RuntimeError("no alive shards to route to "
                               f"({pl.num_shards} shards, all failed)")
        ps = set(pages)
        if not ps or len(alive) == 1:
            return alive[0]
        scores = {s: len(ps & pl.owned_sets[s]) for s in alive}
        best_score = max(scores.values())
        tied = [s for s in alive if scores[s] == best_score]
        if len(tied) > 1 and self.balance_replicas \
                and ps & pl.replicated:
            chosen = min(tied,
                         key=lambda s: (self.batches_per_shard.get(s, 0), s))
            if record and chosen != tied[0]:
                self.rebalanced += 1
            return chosen
        return tied[0]

    def split(self, pages, shard: int) -> Tuple[List[int], List[int]]:
        """(owned, borrowed) of ``pages`` relative to ``shard``."""
        pl = self._placement()
        owned, borrowed = [], []
        for p in sorted(set(int(p) for p in pages)):
            (owned if shard in pl.shards_of(p) else borrowed).append(p)
        return owned, borrowed

    def route(self, pages, record: bool = True) -> RouteDecision:
        """Route one batch; ``record=False`` recomputes the decision
        without counting stats (deterministic given the same observed
        per-shard loads)."""
        pl = self._placement()
        shard = self.choose(pages, record=record)
        owned, borrowed = self.split(pages, shard)
        if record:
            self.batches_per_shard[shard] = \
                self.batches_per_shard.get(shard, 0) + 1
            self.borrowed_pages += len(borrowed)
            tr = get_tracer()
            if tr.enabled:
                # advisory probes (record=False) never reach the trace:
                # one route event per executed batch, same as the stats
                tr.event("route", kind="policy", shard=shard,
                         owned=len(owned), borrowed=len(borrowed))
        return RouteDecision(shard, tuple(owned), tuple(borrowed),
                             pl.pack_generation)
