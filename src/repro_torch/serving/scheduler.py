"""Batch schedulers for the multi-model serving engines.

The engines (`serving/engine.py`) used to drain their per-model queues
with a hard-coded round-robin sweep.  This module turns batch ordering
into a policy:

  * ``fifo``           — global arrival order, model-oblivious.
  * ``round_robin``    — one batch per model per sweep (the old behavior;
    fair, but interleaves models that share nothing, thrashing the pool).
  * ``dedup_affinity`` — co-schedules batches whose page working sets
    overlap the currently *resident* pages, so model variants that share
    deduplicated pages run back-to-back and turn sharing into hits
    (paper Sec. 6: the Eq.-2 win only materializes if sharers actually
    arrive within the reuse horizon).  Ties break by arrival order, and a
    starvation bound forces the oldest batch after ``max_defer``
    consecutive deferrals, so affinity never parks a cold model forever.

Schedulers see batches as :class:`ScheduledBatch` — payload plus the
batch's estimated page working set (the engine computes it at submit
time from the store's packing; that is what makes affinity scheduling
cheap: no weight access, just page-id set intersections).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque, Dict, Iterable, List, Optional, Set

__all__ = ["ScheduledBatch", "BatchScheduler", "FifoScheduler",
           "RoundRobinScheduler", "DedupAffinityScheduler",
           "SCHEDULERS", "make_scheduler"]


@dataclasses.dataclass
class ScheduledBatch:
    """One queued batch: payload + the page working set it was
    estimated to touch (for affinity scheduling and lookahead)."""
    model: str
    payload: object                    # engine-specific (docs, prompts, ...)
    seq: int                           # global arrival order
    pages: Optional[frozenset] = None  # estimated page working set
    pages_gen: Optional[int] = None    # packing generation pages came from
    shard: Optional[int] = None        # routed shard (sharded serving)


class BatchScheduler:
    """Queue of submitted batches + a policy for what runs next."""

    name = "base"

    def __init__(self) -> None:
        self._seq = 0

    # -- submission ----------------------------------------------------------
    def submit(self, model: str, payload, pages: Optional[Iterable] = None,
               pages_gen: Optional[int] = None,
               shard: Optional[int] = None) -> ScheduledBatch:
        """``pages_gen`` records which ``ModelStore.pack_generation`` the
        page ids were minted under; engines use it to spot batches whose
        cached working set a later repack has invalidated.  ``shard`` is
        the router's placement decision for the batch (sharded serving);
        it is advisory — the server re-derives it at run time so a
        repack between submit and run cannot misroute."""
        b = ScheduledBatch(model, payload, self._seq,
                           frozenset(pages) if pages is not None else None,
                           pages_gen, shard)
        self._seq += 1
        self._enqueue(b)
        return b

    # -- policy interface ----------------------------------------------------
    def _enqueue(self, batch: ScheduledBatch) -> None:
        raise NotImplementedError

    def next_batch(self, resident: Optional[Set] = None
                   ) -> Optional[ScheduledBatch]:
        """Pop the next batch to run; ``resident`` is the buffer pool's
        current resident page set (affinity policies use it)."""
        raise NotImplementedError

    def pending(self) -> int:
        raise NotImplementedError

    def pending_batches(self) -> List[ScheduledBatch]:
        """Queued batches in arrival order, *without* dequeuing — the
        queue-aware prefetcher plans lookahead from these page sets
        before spending any idle budget on λ speculation.  Default: an
        empty view, so a scheduler subclass written before this hook
        existed simply gets no lookahead (pure-λ prefetch) instead of a
        crash."""
        return []

    def __bool__(self) -> bool:
        return self.pending() > 0


class FifoScheduler(BatchScheduler):
    """Arrival-order baseline: next batch = oldest batch."""
    name = "fifo"

    def __init__(self) -> None:
        super().__init__()
        self._q: Deque[ScheduledBatch] = deque()

    def _enqueue(self, batch: ScheduledBatch) -> None:
        self._q.append(batch)

    def next_batch(self, resident=None):
        return self._q.popleft() if self._q else None

    def pending(self) -> int:
        return len(self._q)

    def pending_batches(self) -> List[ScheduledBatch]:
        return list(self._q)


class RoundRobinScheduler(BatchScheduler):
    """One batch per model per sweep, models in first-submission order —
    exactly the old ``EmbeddingServingEngine.run`` drain order."""

    name = "round_robin"

    def __init__(self) -> None:
        super().__init__()
        self._queues: "OrderedDict[str, Deque[ScheduledBatch]]" = OrderedDict()
        self._cursor = 0

    def _enqueue(self, batch: ScheduledBatch) -> None:
        self._queues.setdefault(batch.model, deque()).append(batch)

    def next_batch(self, resident=None):
        order = list(self._queues)
        n = len(order)
        for i in range(n):
            j = (self._cursor + i) % n
            if self._queues[order[j]]:
                self._cursor = (j + 1) % n
                return self._queues[order[j]].popleft()
        return None

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_batches(self) -> List[ScheduledBatch]:
        return sorted((b for q in self._queues.values() for b in q),
                      key=lambda b: b.seq)


class DedupAffinityScheduler(BatchScheduler):
    """Pick the queue head whose page set overlaps the resident set most.

    Score = |batch.pages ∩ resident| / |batch.pages| (absolute overlap
    breaks down when models have different working-set sizes).  Ties and
    the cold start fall back to arrival order.  A batch deferred more
    than ``max_defer`` times is forced, bounding starvation.
    """

    name = "dedup_affinity"

    def __init__(self, max_defer: int = 16) -> None:
        super().__init__()
        self.max_defer = max_defer
        self._queues: "OrderedDict[str, Deque[ScheduledBatch]]" = OrderedDict()
        self._deferrals: Dict[str, int] = {}

    def _enqueue(self, batch: ScheduledBatch) -> None:
        self._queues.setdefault(batch.model, deque()).append(batch)

    def _score(self, batch: ScheduledBatch, resident: Set) -> float:
        if not batch.pages:
            return 0.0
        return len(batch.pages & resident) / len(batch.pages)

    def next_batch(self, resident=None):
        heads = [(m, q[0]) for m, q in self._queues.items() if q]
        if not heads:
            return None
        # starvation bound: run anything deferred too long, oldest first
        starved = [(m, b) for m, b in heads
                   if self._deferrals.get(m, 0) >= self.max_defer]
        if starved:
            model, _ = min(starved, key=lambda mb: mb[1].seq)
        elif resident:
            model, _ = max(
                heads, key=lambda mb: (self._score(mb[1], resident),
                                       -mb[1].seq))
        else:
            model, _ = min(heads, key=lambda mb: mb[1].seq)
        for m, q in self._queues.items():
            if q:
                self._deferrals[m] = 0 if m == model \
                    else self._deferrals.get(m, 0) + 1
        return self._queues[model].popleft()

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_batches(self) -> List[ScheduledBatch]:
        return sorted((b for q in self._queues.values() for b in q),
                      key=lambda b: b.seq)


SCHEDULERS = {
    "fifo": FifoScheduler,
    "round_robin": RoundRobinScheduler,
    "dedup_affinity": DedupAffinityScheduler,
}


def make_scheduler(policy, **kwargs) -> BatchScheduler:
    """Resolve a policy name (or pass through an instance) to a
    :class:`BatchScheduler`."""
    if isinstance(policy, BatchScheduler):
        return policy
    if policy not in SCHEDULERS:
        raise ValueError(f"unknown scheduler policy {policy!r}; "
                         f"have {sorted(SCHEDULERS)}")
    return SCHEDULERS[policy](**kwargs)
