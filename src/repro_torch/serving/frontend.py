"""Request-level serving front end: SLO-driven continuous batching and
cost-based admission over the existing engines.

The generator (``serving/traffic.py``) produces an open-loop arrival
stream; this module turns it into engine batches:

  arrival -> admission -> formation -> (engine) schedule -> route -> serve

* **Continuous batch formation** — queued requests for the same model
  merge into one engine batch.  A model's batch closes when it reaches
  ``max_batch`` or when the oldest member's SLO slack no longer covers
  the batch's estimated service time (waiting any longer would blow the
  deadline the batch was being held open to amortize).
* **Cost-based admission** — among closeable batches the frontend
  dispatches the one with the lowest estimated fetch cost per request:
  the candidate's page working set (``ModelStore.model_pages`` /
  the batch's own page estimate) is diffed against the routed shard's
  *own* resident set (``ShardRouter`` + per-shard residency), so a
  batch whose pages are already slab-resident on its shard — the dedup
  affinity win — goes first and cold batches pay their fetch when they
  must, not ahead of hot ones.
* **Shedding** — a request whose deadline cannot be met even by
  dispatching *now* (``deadline < now + est_service``) is shed instead
  of served dead-on-arrival; shed counts land in
  :class:`~repro.serving.engine.ServeStats` and goodput reports the
  fraction of offered requests served within SLO.
* **Virtual-clock discipline** — the whole simulation runs on a
  :class:`~repro.serving.traffic.VirtualClock`: queueing time is idle
  channel time, fetch time is the engine's (deterministic) virtual
  storage seconds, compute time is either a deterministic
  :class:`BatchComputeModel` (benchmarks: bit-stable under a seed) or
  the engine's measured wall compute folded onto the clock.  The
  ``frontend-clock`` lint enforces that no path here consumes time
  without charging a named channel.

``policy="naive"`` is the control: per-arrival FIFO dispatch, one
request per batch, no admission, no shedding — what a serving tier
without a front end does.  ``BENCH_traffic.json`` measures both.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..obs import get_tracer
from .engine import LMServingEngine, ServeStats
from .traffic import Request, VirtualClock

__all__ = ["BatchComputeModel", "RequestLedger", "ServingFrontend"]

#: EMA smoothing for observed per-model arrival rates and compute cost
#: (mirrors BufferPool's rate_ema so the λ feeds compare like for like)
_RATE_EMA = 0.2
_EPS = 1e-12


def _residual_split(total: float, part: float) -> Tuple[float, float]:
    """Split ``total`` into ``(a, b)`` with ``a + b == total`` *exactly*
    in floats and ``a`` as close to ``part`` as that allows.  Trace
    stage breakdowns use this so per-request stage sums reproduce the
    reported latency bit-for-bit (naive ``a + (total - a)`` can miss
    ``total`` by an ulp)."""
    a = part
    for _ in range(4):
        b = total - a
        if a + b == total:
            return a, b
        a = total - b
    return 0.0, total


@dataclasses.dataclass
class BatchComputeModel:
    """Deterministic per-batch compute-time model for the virtual
    clock: ``base + per_request * n`` seconds per dispatched batch.
    Benchmarks use it so latency distributions are bit-stable under a
    fixed seed; without one the frontend folds the engine's measured
    wall compute onto the clock instead."""
    base: float = 5e-4
    per_request: float = 5e-5

    def batch_seconds(self, n: int) -> float:
        """Virtual compute seconds for an ``n``-request batch."""
        return self.base + self.per_request * max(0, int(n))


@dataclasses.dataclass
class RequestLedger:
    """At-most-once request accounting that survives restarts
    (DESIGN.md §11).

    A request id moves ``offered`` → queued (offered minus every other
    set) → ``in_flight`` → ``served`` | ``shed``.  ``in_flight`` is the
    crash window: the dispatch intent is persisted *before* the engine
    computes, and the id only becomes ``served`` after results are
    captured.  A restart therefore re-admits queued and in-flight ids
    (their results died with the process; recompute is deterministic)
    and never re-serves a served one — delivery is at-most-once, and
    nothing is dropped beyond explicit sheds.
    """
    offered: Set[int] = dataclasses.field(default_factory=set)
    served: Set[int] = dataclasses.field(default_factory=set)
    shed: Set[int] = dataclasses.field(default_factory=set)
    in_flight: Set[int] = dataclasses.field(default_factory=set)
    readmitted: int = 0                  # cumulative across restarts

    def admit(self, rid: int) -> None:
        self.offered.add(int(rid))

    def record_served(self, rid: int) -> None:
        self.in_flight.discard(int(rid))
        self.served.add(int(rid))

    def record_shed(self, rid: int) -> None:
        self.in_flight.discard(int(rid))
        self.shed.add(int(rid))

    def to_dict(self) -> Dict:
        return {"offered": sorted(self.offered),
                "served": sorted(self.served),
                "shed": sorted(self.shed),
                "in_flight": sorted(self.in_flight),
                "readmitted": int(self.readmitted)}

    @classmethod
    def from_dict(cls, d: Dict) -> "RequestLedger":
        return cls(offered={int(r) for r in d["offered"]},
                   served={int(r) for r in d["served"]},
                   shed={int(r) for r in d["shed"]},
                   in_flight={int(r) for r in d["in_flight"]},
                   readmitted=int(d.get("readmitted", 0)))


class ServingFrontend:
    """Continuous-batching front end over one serving engine.

    ``engine``: an :class:`EmbeddingServingEngine` or
    :class:`LMServingEngine` (1 or N shards — routing happens inside
    the engine's server).  ``max_batch``: formation cap per dispatched
    batch.  ``policy``: ``"slo"`` (formation + admission + shedding) or
    ``"naive"`` (per-arrival FIFO control).  ``compute_model``: a
    :class:`BatchComputeModel` for deterministic virtual compute;
    ``None`` folds measured wall compute onto the clock.
    ``capture=True`` keeps each request's result rows (logits / tokens)
    in :attr:`results` for the bit-equality tests.

    When the engine has a prefetcher, the frontend feeds it the
    *observed* per-model arrival rates (EMA over the virtual clock) via
    ``Prefetcher.attach_rates`` — the λ of Eq. 2 measured at the door
    instead of back-derived from pool access counts.
    """

    POLICIES = ("slo", "naive")

    def __init__(self, engine, max_batch: int = 8, policy: str = "slo",
                 compute_model: Optional[BatchComputeModel] = None,
                 capture: bool = True,
                 snapshot_path: Optional[str] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"have {self.POLICIES}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.policy = policy
        self.compute_model = compute_model
        self.capture = capture
        # warm restart (DESIGN.md §11): when set, the frontend persists
        # its snapshot around every dispatch (atomic rename), so a
        # killed process resumes via ServingFrontend.restore
        self.snapshot_path = snapshot_path
        self.ledger = RequestLedger()
        self._resumed = False
        self.clock = VirtualClock()
        self.results: Dict[int, np.ndarray] = {}
        self.dispatched: List[Tuple[str, List[Request]]] = []
        self._lm = isinstance(engine, LMServingEngine)
        self._queues: Dict[str, List[Request]] = {}   # model -> FIFO
        self._fifo: List[Request] = []                # naive global FIFO
        self._rates: Dict[str, float] = {}            # observed λ (EMA)
        self._last_arrival: Dict[str, float] = {}
        self._cpr: Optional[float] = None             # EMA compute/request
        pf = getattr(engine, "prefetcher", None)
        if pf is not None and hasattr(pf, "attach_rates"):
            pf.attach_rates(self.arrival_rates)

    # -- observability -----------------------------------------------------
    def arrival_rates(self) -> Dict[str, float]:
        """Observed per-model arrival rates (requests per virtual
        second, EMA-smoothed) — the λ feed for the prefetcher."""
        return dict(self._rates)

    @property
    def stats(self) -> ServeStats:
        """The engine's stats object (request-level counters included)."""
        return self.engine.stats

    # -- sizing helpers ----------------------------------------------------
    def _rows(self, req: Request) -> int:
        payload = req.payload[0] if self._lm else req.payload
        return int(np.asarray(payload).shape[0])

    def _merge(self, reqs: List[Request]):
        """One engine payload from a batch's requests (same model)."""
        if self._lm:
            steps = {int(r.payload[1]) for r in reqs}
            if len(steps) != 1:
                raise ValueError(
                    f"cannot merge LM requests with mixed decode steps "
                    f"{sorted(steps)} into one batch")
            prompts = np.concatenate([np.asarray(r.payload[0])
                                      for r in reqs], axis=0)
            return prompts, steps.pop()
        return np.concatenate([np.asarray(r.payload) for r in reqs],
                              axis=0)

    # -- cost model --------------------------------------------------------
    def _batch_pages(self, model: str, reqs: List[Request]) -> List[int]:
        server = self.engine.server
        if self._lm:
            return server.store.model_pages(model)
        rows = np.unique(np.concatenate(
            [np.asarray(r.payload).reshape(-1) for r in reqs]))
        return server.embedding_rows_pages(
            model, self.engine.embed_tensor, rows)

    def _est_fetch(self, model: str, reqs: List[Request]) -> float:
        """Estimated virtual fetch seconds for this batch: its page
        working set diffed against the shard the router would place it
        on (advisory route, nothing recorded), costed as one grouped
        fetch.  This is the admission score — misses against the
        routed shard's *own* residency, so dedup affinity (pages kept
        hot by other variants on the same shard) directly lowers a
        candidate's price."""
        server = self.engine.server
        pages = self._batch_pages(model, reqs)
        router = getattr(server, "router", None)
        if router is not None:
            shard = router.route(pages, record=False).shard
            resident = server.shard_resident_pages(shard)
        else:
            resident = server.shard_resident_pages()
        misses = len(set(pages) - resident)
        return server.storage.fetch_group_seconds(server.page_bytes,
                                                  misses)

    def _est_compute(self, n: int) -> float:
        if self.compute_model is not None:
            return self.compute_model.batch_seconds(n)
        return (self._cpr or 0.0) * n

    def _est_service(self, model: str, reqs: List[Request]) -> float:
        rows = sum(self._rows(r) for r in reqs)
        return self._est_fetch(model, reqs) + self._est_compute(rows)

    # -- queue management --------------------------------------------------
    def _pending(self) -> int:
        if self.policy == "naive":
            return len(self._fifo)
        return sum(len(q) for q in self._queues.values())

    def _admit(self, req: Request) -> None:
        """Enqueue one arrival and fold it into the λ estimate."""
        # offered counts at admission (not run() entry) so a killed run
        # books only what it actually saw and a resume never re-counts
        self.engine.stats.offered_requests += 1
        self.ledger.admit(req.rid)
        last = self._last_arrival.get(req.model)
        self._last_arrival[req.model] = req.arrival_t
        if last is not None and req.arrival_t > last:
            inst = 1.0 / (req.arrival_t - last)
            prev = self._rates.get(req.model)
            self._rates[req.model] = inst if prev is None else \
                (1.0 - _RATE_EMA) * prev + _RATE_EMA * inst
        if self.policy == "naive":
            self._fifo.append(req)
        else:
            self._queues.setdefault(req.model, []).append(req)

    # -- formation ---------------------------------------------------------
    def _form(self) -> Optional[Tuple[str, List[Request]]]:
        """Pick the next batch to dispatch, or None to keep waiting.

        A model's queue is *closeable* when it holds ``max_batch``
        requests (nothing to gain by waiting) or when its oldest
        member's slack no longer covers the estimated service time
        (*forced*: wait any longer and the deadline dies).  Forced
        batches dispatch first (earliest deadline); otherwise the
        cheapest candidate per request wins — cost-based admission."""
        if self.policy == "naive":
            if not self._fifo:
                return None
            req = self._fifo.pop(0)
            return req.model, [req]
        forced: List[Tuple[float, str]] = []
        full: List[Tuple[float, float, str]] = []
        now = self.clock.now
        for model, q in self._queues.items():
            take = q[: self.max_batch]
            est = self._est_service(model, take)
            if now >= take[0].deadline - est - _EPS:
                forced.append((take[0].deadline, model))
            elif len(q) >= self.max_batch:
                n = max(1, sum(self._rows(r) for r in take))
                full.append((self._est_fetch(model, take) / n,
                             take[0].arrival_t, model))
        if forced:
            forced.sort()
            model = forced[0][1]
        elif full:
            full.sort()
            model = full[0][2]
        else:
            return None
        q = self._queues[model]
        batch, self._queues[model] = q[: self.max_batch], q[self.max_batch:]
        if not self._queues[model]:
            del self._queues[model]
        return model, batch

    def _next_forced_time(self) -> Optional[float]:
        """Earliest future instant at which some queue becomes forced
        (its oldest member's slack hits the estimated service time)."""
        out = None
        for model, q in self._queues.items():
            take = q[: self.max_batch]
            t = take[0].deadline - self._est_service(model, take)
            if out is None or t < out:
                out = t
        return out

    # -- dispatch ----------------------------------------------------------
    def _capture_results(self, kept: List[Request]) -> None:
        out = self.engine.last_tokens if self._lm \
            else self.engine.last_logits
        if out is None:
            return
        out = np.asarray(out)
        row = 0
        for r in kept:
            n = self._rows(r)
            self.results[r.rid] = out[row: row + n].copy()
            row += n

    def _dispatch(self, model: str, batch: List[Request]) -> None:
        """Shed the dead, serve the rest, charge the clock, record
        per-request latencies."""
        tr = get_tracer()
        st: ServeStats = self.engine.stats
        kept = batch
        if self.policy == "slo":
            est = self._est_service(model, batch)
            kept = [r for r in batch
                    if r.deadline >= self.clock.now + est - _EPS]
            st.shed_requests += len(batch) - len(kept)
            kept_rids = {r.rid for r in kept}
            for r in batch:
                if r.rid not in kept_rids:
                    self.ledger.record_shed(r.rid)
            if tr.enabled and len(kept) < len(batch):
                now = self.clock.now
                for r in batch:
                    if r.deadline >= now + est - _EPS:
                        continue
                    # a shed request's tree is queue-only: no service
                    tr.emit("request", r.arrival_t, now, kind="request",
                            rid=r.rid, model=model, shed=True,
                            slo_miss=False, queue_s=now - r.arrival_t,
                            service_s=0.0, fetch_s=0.0, compute_s=0.0,
                            latency_s=now - r.arrival_t)
            if not kept:
                self._persist()
                return
        # dispatch intent: in-flight ids hit the durable snapshot BEFORE
        # the engine computes, so a crash from here to the served mark
        # re-admits exactly these requests on restart (at-most-once)
        for r in kept:
            self.ledger.in_flight.add(r.rid)
        self._persist()
        start = self.clock.now
        f0, c0 = st.fetch_seconds, st.compute_seconds
        with tr.span("dispatch", kind="frontend", model=model,
                     requests=len(kept)) as dsp:
            if self._lm:
                prompts, steps = self._merge(kept)
                self.engine.submit(model, prompts, steps=steps)
            else:
                self.engine.submit(model, self._merge(kept))
            self.engine.run(max_batches=1)
            d_fetch = st.fetch_seconds - f0
            rows = sum(self._rows(r) for r in kept)
            if self.compute_model is not None:
                d_compute = self.compute_model.batch_seconds(rows)
            else:
                d_compute = st.compute_seconds - c0
            channel = self.engine.server.storage.channel
            # charged spans: the exact floats handed to clock.advance,
            # so span channel totals replay the clock ledger bit-for-bit
            with tr.span("fetch", kind="frontend", channel=channel,
                         charge=d_fetch):
                self.clock.advance(d_fetch, channel)
            with tr.span("compute", kind="frontend", channel="compute",
                         charge=d_compute):
                self.clock.advance(d_compute, "compute")
            dsp.set(fetch_s=d_fetch, compute_s=d_compute)
        done = self.clock.now
        service = done - start
        inst = d_compute / max(1, rows)
        self._cpr = inst if self._cpr is None else \
            (1.0 - _RATE_EMA) * self._cpr + _RATE_EMA * inst
        for r in kept:
            st.queue_latencies.append(start - r.arrival_t)
            st.service_latencies.append(service)
            st.request_latencies.append(done - r.arrival_t)
            missed = done > r.deadline + _EPS
            if missed:
                st.slo_misses += 1
            if tr.enabled:
                # residual stage splits: queue + service == latency and
                # fetch + compute == service hold *exactly* in floats
                latency = done - r.arrival_t
                queue_s, service_s = _residual_split(
                    latency, start - r.arrival_t)
                fetch_s, compute_s = _residual_split(service_s, d_fetch)
                tr.emit("request", r.arrival_t, done, kind="request",
                        rid=r.rid, model=model, shed=False,
                        slo_miss=missed, queue_s=queue_s,
                        service_s=service_s, fetch_s=fetch_s,
                        compute_s=compute_s, latency_s=latency)
        self.dispatched.append((model, kept))
        if self.capture:
            self._capture_results(kept)
        for r in kept:
            self.ledger.record_served(r.rid)
        self._persist()

    # -- the event loop ----------------------------------------------------
    def run(self, requests: List[Request],
            max_dispatches: Optional[int] = None) -> ServeStats:
        """Serve an arrival stream to completion (discrete-event loop
        on the virtual clock); returns the engine's stats with the
        request-level counters filled in.

        Ids the ledger already knows — served, shed, or re-admitted by
        :meth:`restore` — are not offered again, so a resumed run can
        be handed the SAME regenerated stream and picks up exactly
        where the crash left it.  ``max_dispatches`` stops after that
        many batches (the kill-and-restart harness; the books stay
        balanced, pending requests wait in the persisted snapshot)."""
        tr = get_tracer()
        # on a resumed run the caller hands back the SAME regenerated
        # stream, so ids the ledger already offered are filtered out;
        # a fresh frontend must NOT filter (independent streams may
        # legitimately reuse rid numbering)
        if self._resumed:
            reqs = sorted((r for r in requests
                           if r.rid not in self.ledger.offered),
                          key=lambda r: (r.arrival_t, r.rid))
        else:
            reqs = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        st: ServeStats = self.engine.stats
        i = 0
        dispatched = 0
        while i < len(reqs) or self._pending():
            if max_dispatches is not None and dispatched >= max_dispatches:
                break
            while i < len(reqs) and reqs[i].arrival_t <= self.clock.now \
                    + _EPS:
                if tr.enabled:
                    tr.event("admit", kind="frontend", rid=reqs[i].rid,
                             model=reqs[i].model)
                self._admit(reqs[i])
                i += 1
            batch = self._form()
            if batch is not None:
                self._dispatch(*batch)
                dispatched += 1
                continue
            # nothing closeable: idle to the next decision point (next
            # arrival, or the instant a queue's slack runs out).  The
            # charged idle span is arithmetically tick_to(): same dt,
            # same single advance.
            candidates = []
            if i < len(reqs):
                candidates.append(reqs[i].arrival_t)
            forced = self._next_forced_time()
            if forced is not None:
                candidates.append(forced)
            if not candidates:
                break
            t = max(min(candidates), self.clock.now)
            if t > self.clock.now:
                dt = t - self.clock.now
                with tr.span("idle", kind="frontend", channel="idle",
                             charge=dt):
                    self.clock.advance(dt, "idle")
        # a run must leave the books balanced: every simulated second
        # in a named channel, and (when tracing this clock) every
        # charged second witnessed by a span.  A *resumed* clock
        # carries pre-crash channel time no span of this process
        # witnessed, so the span cross-check only applies to runs that
        # started on this tracer's watch.
        self._persist()
        self.clock.assert_conserved()
        if getattr(tr, "clock", None) is self.clock and not self._resumed:
            tr.assert_matches_clock(self.clock)
        return st

    # -- warm restart ------------------------------------------------------
    def pending_requests(self) -> int:
        """Requests queued (including restart re-admissions) but not
        yet dispatched or shed."""
        return self._pending()

    def assert_ledger_conserved(self) -> None:
        """The at-most-once book balance: ``served + shed + in-flight +
        queued == offered`` with no id in two terminal states."""
        led = self.ledger
        dup = led.served & led.shed
        if dup:
            raise AssertionError(
                f"requests both served and shed: {sorted(dup)[:5]}")
        resolved = (len(led.served) + len(led.shed)
                    + len(led.in_flight) + self._pending())
        if resolved != len(led.offered):
            raise AssertionError(
                f"request ledger leaked: {len(led.offered)} offered but "
                f"{len(led.served)} served + {len(led.shed)} shed + "
                f"{len(led.in_flight)} in-flight + {self._pending()} "
                "queued")

    #: ServeStats fields a snapshot carries across a restart; scalars
    #: merge additively into the fresh engine's stats, lists extend
    _SNAP_STATS = ("requests", "batches", "offered_requests",
                   "shed_requests", "slo_misses", "readmitted_requests",
                   "fetch_seconds", "compute_seconds", "pages_fetched",
                   "queue_latencies", "service_latencies",
                   "request_latencies")

    def snapshot(self) -> Dict:
        """JSON-safe frontend state: clock ledger, queued request ids,
        the at-most-once ledger, λ/compute estimators and the
        request-level stats.  Payloads are NOT serialized — a restart
        regenerates the (seeded, deterministic) request stream and
        :meth:`restore` re-binds ids to the regenerated objects."""
        st = self.engine.stats
        stats = {}
        for key in self._SNAP_STATS:
            v = getattr(st, key)
            stats[key] = list(v) if isinstance(v, list) else v
        return {
            "version": 1,
            "policy": self.policy,
            "max_batch": self.max_batch,
            "clock": self.clock.snapshot(),
            "queued": {m: [r.rid for r in q]
                       for m, q in self._queues.items()},
            "fifo": [r.rid for r in self._fifo],
            "ledger": self.ledger.to_dict(),
            "rates": dict(self._rates),
            "last_arrival": dict(self._last_arrival),
            "cpr": self._cpr,
            "stats": stats,
        }

    def _persist(self) -> None:
        if self.snapshot_path is None:
            return
        tmp = f"{self.snapshot_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, self.snapshot_path)   # never a torn snapshot

    @classmethod
    def restore(cls, engine, snap: Dict, requests: List[Request],
                compute_model: Optional[BatchComputeModel] = None,
                capture: bool = True,
                snapshot_path: Optional[str] = None) -> "ServingFrontend":
        """Warm restart from a :meth:`snapshot` (or its JSON) after a
        crash: a FRESH engine (its pools rebuild lazily from the
        recovered store) plus the snapshot's clock/ledger/queues.

        ``requests`` must contain every id the snapshot references —
        the deterministic regeneration of the original stream.  Queued
        ids re-enter their queues; in-flight ids (dispatched, never
        acknowledged) are re-admitted for recompute.  Both count as
        re-admissions in the ledger and in
        ``ServeStats.readmitted_requests``."""
        fe = cls(engine, max_batch=int(snap["max_batch"]),
                 policy=str(snap["policy"]), compute_model=compute_model,
                 capture=capture, snapshot_path=snapshot_path)
        fe.clock = VirtualClock.from_snapshot(snap["clock"])
        fe.ledger = RequestLedger.from_dict(snap["ledger"])
        fe._rates = {str(m): float(v) for m, v in snap["rates"].items()}
        fe._last_arrival = {str(m): float(v)
                            for m, v in snap["last_arrival"].items()}
        fe._cpr = None if snap["cpr"] is None else float(snap["cpr"])
        by_rid = {r.rid: r for r in requests}
        readmitted = 0
        for model, rids in snap["queued"].items():
            fe._queues[model] = [by_rid[rid] for rid in rids]
            readmitted += len(rids)
        fe._fifo = [by_rid[rid] for rid in snap["fifo"]]
        readmitted += len(fe._fifo)
        # in-flight = the crash window: dispatched, never acknowledged.
        # The results died with the process; re-queue for deterministic
        # recompute — delivery stays at-most-once because served ids
        # are never offered again.
        for rid in sorted(fe.ledger.in_flight):
            req = by_rid[rid]
            if fe.policy == "naive":
                fe._fifo.append(req)
            else:
                fe._queues.setdefault(req.model, []).append(req)
            readmitted += 1
        fe.ledger.in_flight.clear()
        # in-flight ids were dispatched first but re-entered last:
        # restore arrival order so EDF/FIFO formation is unchanged
        for q in fe._queues.values():
            q.sort(key=lambda r: (r.arrival_t, r.rid))
        fe._fifo.sort(key=lambda r: (r.arrival_t, r.rid))
        st: ServeStats = engine.stats
        for key, v in snap["stats"].items():
            cur = getattr(st, key)
            if isinstance(cur, list):
                cur.extend(v)
            elif isinstance(cur, float):
                setattr(st, key, cur + float(v))
            else:
                setattr(st, key, cur + int(v))
        fe.ledger.readmitted += readmitted
        st.readmitted_requests += readmitted
        fe._resumed = True
        return fe
