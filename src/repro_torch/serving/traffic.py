"""Open-loop request traffic on the virtual clock.

The paper's serving claims (Sec. 8, Fig. 8) are about latency under
*load*: individual requests arriving over time, not pre-built batches.
This module supplies the missing request stream:

  * :class:`Request` — one typed arrival: ``(model, payload,
    arrival_t, deadline)`` stamped in virtual seconds.
  * :class:`OpenLoopTraffic` — a seeded open-loop generator: Poisson
    interarrivals at a fixed offered rate (arrivals never wait for the
    server — that is what makes the loop *open*), model popularity
    drawn Zipf(α) so a few variants are hot and the tail is cold, the
    regime dedup-aware caching is built for.
  * :class:`VirtualClock` — the frontend's single-channel discrete
    event clock.  Every second of simulated time is charged to a named
    channel (``storage`` / ``compute`` / ``idle`` / ...), mirroring the
    :class:`~repro.serving.engine.StorageModel` channel discipline, so
    "no free latency" is auditable after the fact.
  * :class:`TrafficSpec` — the ``launch/serve.py --traffic`` grammar
    (``"rate=200,zipf=1.1,slo_ms=50,seed=0"``), same comma key=value
    spelling as :class:`~repro.storage.faults.FaultSpec`.

Everything is deterministic under a fixed seed: one
``np.random.default_rng(seed)`` stream drives interarrivals, model
choice and payload synthesis, so a traffic trace — and every latency
measured through it — is exactly reproducible.  No wall time anywhere
(the ``wallclock`` lint bans it; the ``frontend-clock`` lint
additionally pins this module and the frontend to the virtual clock).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Request", "TrafficSpec", "VirtualClock", "OpenLoopTraffic",
           "zipf_weights", "zoo_popularity"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One arrival in the open-loop stream.  ``payload`` is whatever
    the target engine's ``submit`` takes (a docs array for the
    embedding engine, ``(prompts, steps)`` for the LM engine);
    ``deadline = arrival_t + slo`` is the latest acceptable completion
    on the virtual clock."""
    rid: int
    model: str
    payload: object
    arrival_t: float
    deadline: float

    def slack(self, now: float) -> float:
        """Virtual seconds until this request blows its SLO."""
        return self.deadline - now


# ------------------------------------------------------------- spec ------
_FLOAT_FIELDS = ("rate", "zipf", "slo_ms")
_INT_FIELDS = ("seed", "requests", "max_batch")


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """The ``--traffic`` CLI grammar: offered rate (requests per
    virtual second), Zipf popularity exponent, per-request SLO, seed,
    stream length and the frontend's batch-size cap."""
    rate: float = 200.0
    zipf: float = 1.1
    slo_ms: float = 50.0
    seed: int = 0
    requests: int = 200
    max_batch: int = 8

    @classmethod
    def parse(cls, text: "str | TrafficSpec | None") -> "TrafficSpec":
        """``"rate=500,zipf=1.2,slo_ms=25,seed=7"`` -> TrafficSpec;
        the empty string parses to the defaults."""
        if isinstance(text, TrafficSpec):
            return text
        kw = {}
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad traffic spec item {part!r} "
                                 "(expected key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in _FLOAT_FIELDS:
                kw[k] = float(v)
            elif k in _INT_FIELDS:
                kw[k] = int(v)
            else:
                raise ValueError(
                    f"unknown traffic spec key {k!r} (expected one of "
                    f"{_FLOAT_FIELDS + _INT_FIELDS})")
        spec = cls(**kw)
        if spec.rate <= 0:
            raise ValueError("traffic rate must be > 0")
        if spec.slo_ms <= 0:
            raise ValueError("traffic slo_ms must be > 0")
        return spec

    def __str__(self) -> str:
        default = TrafficSpec()
        items = [f"{f.name}={getattr(self, f.name)}"
                 for f in dataclasses.fields(self)
                 if getattr(self, f.name) != getattr(default, f.name)]
        return ",".join(items) or "default"


# ------------------------------------------------------------- clock -----
class VirtualClock:
    """Single-lane virtual clock with named-channel attribution.

    ``now`` only moves through :meth:`advance` (charge ``seconds`` to a
    named channel) or :meth:`tick_to` (idle forward to an absolute
    time), so after a run ``sum(channels.values()) == now`` — every
    simulated second is accounted to storage, compute, idle or another
    named channel, never conjured."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self._start = float(start)
        self.channels: Dict[str, float] = {}

    def advance(self, seconds: float, channel: str) -> float:
        """Charge ``seconds`` of ``channel`` time; returns the new now."""
        if seconds < 0:
            raise ValueError(f"cannot advance the clock by {seconds!r}s")
        self.channels[channel] = self.channels.get(channel, 0.0) + seconds
        self.now += seconds
        return self.now

    def tick_to(self, t: float, channel: str = "idle") -> float:
        """Idle forward to absolute virtual time ``t`` (no-op when
        ``t`` is in the past); returns the new now."""
        if t > self.now:
            self.advance(t - self.now, channel)
        return self.now

    def spent(self, channel: str) -> float:
        """Seconds charged to ``channel`` so far."""
        return self.channels.get(channel, 0.0)

    def snapshot(self) -> Dict:
        """JSON-safe state for warm restart: ``from_snapshot`` rebuilds
        a clock with the same now/start/channel ledger, so conservation
        (and every latency measured against ``now``) carries across a
        process death."""
        return {"now": self.now, "start": self._start,
                "channels": dict(self.channels)}

    @classmethod
    def from_snapshot(cls, snap: Dict) -> "VirtualClock":
        """Rebuild a clock from :meth:`snapshot` output."""
        clock = cls(float(snap.get("start", 0.0)))
        clock.channels = {str(k): float(v)
                          for k, v in snap["channels"].items()}
        clock.now = float(snap["now"])
        return clock

    def assert_conserved(self, tol: float = 1e-9) -> None:
        """Fail loudly if any simulated second escaped the channel
        ledger: ``sum(channels) == now - start`` within ``tol``.  A
        future un-charged mutation of ``now`` shows up here instead of
        silently skewing idle-time attribution."""
        booked = sum(self.channels.values())
        elapsed = self.now - self._start
        if abs(booked - elapsed) > tol:
            raise AssertionError(
                f"virtual clock leaked time: channels sum to "
                f"{booked!r}s but now-start is {elapsed!r}s "
                f"(channels={self.channels!r})")


# ------------------------------------------------------- popularity ------
def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """Zipf(α) probability vector over ``n`` ranks: weight of rank k is
    ∝ 1 / k**α (α=0 degenerates to uniform)."""
    if n <= 0:
        raise ValueError("need at least one model")
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(alpha)
    return w / w.sum()


def zoo_popularity(alpha: float = 1.1) -> Dict[str, float]:
    """Zipf(α) popularity over the full ``configs/`` model zoo (the
    reduced-shape architectures ``list_archs`` knows), rank order =
    registry order.  The handful of head archs soak up most of the
    traffic — the mixed-zoo regime the dedup store is meant to serve."""
    from ..configs import list_archs
    archs = list_archs()
    return dict(zip(archs, zipf_weights(len(archs), alpha).tolist()))


# -------------------------------------------------------- generator ------
class OpenLoopTraffic:
    """Seeded open-loop request generator.

    ``models``: the serveable model names, hottest first (rank order is
    Zipf rank order).  ``rate``: offered load in requests per virtual
    second — arrivals are Poisson, so interarrival gaps are Exp(rate)
    draws.  ``slo_s``: each request's deadline is ``arrival + slo_s``.
    ``payload_fn(model, rid, rng) -> payload`` synthesizes the request
    body from the generator's own rng stream (one stream: trace and
    payloads reproduce together); ``None`` leaves payloads ``None``
    for tests that only study arrival dynamics.
    """

    def __init__(self, models: Sequence[str], rate: float,
                 zipf_alpha: float = 1.1, slo_s: float = 0.05,
                 seed: int = 0,
                 payload_fn: Optional[Callable] = None):
        if rate <= 0:
            raise ValueError("offered rate must be > 0")
        self.models = list(models)
        self.rate = float(rate)
        self.slo_s = float(slo_s)
        self.weights = zipf_weights(len(self.models), zipf_alpha)
        self.payload_fn = payload_fn
        self.rng = np.random.default_rng(seed)
        self._next_rid = 0
        self._t = 0.0

    def generate(self, n: int) -> List[Request]:
        """The next ``n`` arrivals of the stream (call again to
        continue it: the clock and rng carry over)."""
        out: List[Request] = []
        for _ in range(n):
            self._t += float(self.rng.exponential(1.0 / self.rate))
            model = self.models[int(self.rng.choice(len(self.models),
                                                    p=self.weights))]
            rid = self._next_rid
            self._next_rid += 1
            payload = self.payload_fn(model, rid, self.rng) \
                if self.payload_fn is not None else None
            out.append(Request(rid=rid, model=model, payload=payload,
                               arrival_t=self._t,
                               deadline=self._t + self.slo_s))
        return out
