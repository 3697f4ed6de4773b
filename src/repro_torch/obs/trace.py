"""Virtual-clock request-path tracing.

A :class:`Tracer` produces nested spans ``(name, kind, start_t,
end_t, channel, attrs)`` timed on a
:class:`~repro.serving.traffic.VirtualClock`.  Three usage shapes:

  * ``with tracer.span("fetch", kind="frontend", channel="ssd",
    charge=dt): clock.advance(dt, "ssd")`` — a *charged* span: the
    span wraps the clock advance and records the **same float** that
    the clock was charged, accumulated into
    :attr:`Tracer.channel_seconds` with the identical
    ``get(ch, 0.0) + x`` update the clock itself performs, in the same
    order.  After a run, per-channel span time equals
    ``VirtualClock.spent`` per channel *exactly* (``==``, no
    tolerance) — see :meth:`Tracer.assert_matches_clock`.
  * ``with tracer.span("fault_group", kind="storage", pages=n) as sp``
    — an *attributed* span (no charge): pure structure + attrs, used
    by engines / pools / backends whose virtual seconds are folded
    onto the clock later by the frontend.  ``sp.set(bytes=...)`` adds
    attrs discovered mid-flight.
  * ``tracer.emit("request", arrival, done, kind="request", rid=...)``
    — a retrospective span for intervals that cannot be live context
    managers because they interleave (one span per request id,
    covering arrival → completion across other requests' dispatches).

The default tracer is :data:`NULL_TRACER`, a no-op that allocates
nothing per call (one shared null context manager, one shared null
span), so instrumentation left in the hot path is free when tracing is
off.  Spans may only be opened via the context manager — the
``span-discipline`` lint bans bare :meth:`Tracer.span_begin` /
:meth:`Tracer.span_end` pairs outside this module.

Retention is a bounded ring: the newest ``ring`` finished spans are
kept (``collections.deque(maxlen=ring)``); eviction drops oldest-first
and never touches the open-span stack or the channel accounting, so a
long run stays bounded without corrupting open trees or conservation.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "use_tracer",
]


class Span:
    """One finished or in-flight span.  ``start_t`` / ``end_t`` are
    virtual seconds (or monotonic event counts when the tracer has no
    clock); ``charge`` is the float charged to ``channel`` on the
    virtual clock, ``None`` for purely attributed spans."""

    __slots__ = ("sid", "parent", "name", "kind", "start_t", "end_t",
                 "channel", "charge", "attrs")

    def __init__(self, sid: int, parent: Optional[int], name: str,
                 kind: str, start_t: float,
                 channel: Optional[str] = None,
                 charge: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.kind = kind
        self.start_t = float(start_t)
        self.end_t: Optional[float] = None
        self.channel = channel
        self.charge = charge
        self.attrs = attrs or {}

    def set(self, **attrs) -> "Span":
        """Attach attrs discovered after the span opened."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        end = self.end_t if self.end_t is not None else self.start_t
        return end - self.start_t

    def to_dict(self) -> dict:
        d = {"sid": self.sid, "parent": self.parent, "name": self.name,
             "kind": self.kind, "start_t": self.start_t,
             "end_t": self.end_t}
        if self.channel is not None:
            d["channel"] = self.channel
        if self.charge is not None:
            d["charge"] = self.charge
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name!r}, kind={self.kind!r}, "
                f"[{self.start_t}, {self.end_t}], "
                f"channel={self.channel!r}, charge={self.charge!r})")


class _SpanHandle:
    """Context manager yielded by :meth:`Tracer.span`; closes the span
    (and books its charge) on exit even when the body raises."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.span_end(self._span)
        return False


class _NullSpan:
    """Shared inert span: ``set`` is a no-op so instrumented code can
    write ``sp.set(...)`` unconditionally."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self


class _NullHandle:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_NULL_HANDLE = _NullHandle()


class NullTracer:
    """The zero-alloc default: every call returns a shared singleton
    and records nothing."""

    __slots__ = ()

    enabled = False
    clock = None

    def span(self, name: str, **kw) -> _NullHandle:
        return _NULL_HANDLE

    def emit(self, name: str, start_t: float, end_t: float, **kw) -> None:
        return None

    def event(self, name: str, **kw) -> None:
        return None

    def spans(self) -> List[Span]:
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Span recorder bound to (at most) one virtual clock.

    ``clock``: a :class:`~repro.serving.traffic.VirtualClock` used as
    the time source; ``None`` falls back to a monotonic event counter
    (ordering-only timestamps for clock-less unit tests).  ``ring``:
    retention cap on *finished* spans — the deque drops oldest-first.

    One tracer is meant to witness one traced run against one fresh
    clock; reusing a tracer across clocks breaks the conservation
    check by construction.
    """

    def __init__(self, clock=None, ring: int = 65536):
        if ring < 1:
            raise ValueError("ring must hold at least one span")
        self.clock = clock
        self.enabled = True
        self.channel_seconds: Dict[str, float] = {}
        self._ring: "deque[Span]" = deque(maxlen=int(ring))
        self._stack: List[Span] = []
        self._next_sid = 0
        self._seq = 0.0   # event-counter fallback time source
        self.dropped = 0  # finished spans evicted by the ring

    # -- time ---------------------------------------------------------------
    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now
        self._seq += 1.0
        return self._seq

    # -- low-level span primitives (context-manager use only: the ----------
    # span-discipline lint bans calling these outside this module) ---------
    def span_begin(self, name: str, kind: str = "span",
                   channel: Optional[str] = None,
                   charge: Optional[float] = None, **attrs) -> Span:
        parent = self._stack[-1].sid if self._stack else None
        sp = Span(self._next_sid, parent, name, kind, self._now(),
                  channel=channel, charge=charge, attrs=attrs)
        self._next_sid += 1
        self._stack.append(sp)
        return sp

    def span_end(self, sp: Span) -> Span:
        if not self._stack or self._stack[-1] is not sp:
            raise RuntimeError(
                f"span {sp.name!r} closed out of order (open stack: "
                f"{[s.name for s in self._stack]})")
        self._stack.pop()
        sp.end_t = self._now()
        if sp.channel is not None and sp.charge is not None:
            # the *identical* update VirtualClock.advance performs, fed
            # the identical float, in the same order -> exact equality
            self.channel_seconds[sp.channel] = \
                self.channel_seconds.get(sp.channel, 0.0) + sp.charge
        self._finish(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(sp)

    # -- public API ---------------------------------------------------------
    def span(self, name: str, kind: str = "span",
             channel: Optional[str] = None,
             charge: Optional[float] = None, **attrs) -> _SpanHandle:
        """Open a nested span as a context manager.  Pass ``channel``
        and ``charge`` together to book virtual seconds (the same float
        handed to ``clock.advance``); either alone is an error."""
        if (channel is None) != (charge is None):
            raise ValueError("channel and charge must be given together")
        return _SpanHandle(self, self.span_begin(
            name, kind=kind, channel=channel, charge=charge, **attrs))

    def emit(self, name: str, start_t: float, end_t: float,
             kind: str = "span", **attrs) -> Span:
        """Record a completed span retrospectively (request trees:
        intervals that interleave and cannot be live context
        managers).  Never charges a channel."""
        parent = self._stack[-1].sid if self._stack else None
        sp = Span(self._next_sid, parent, name, kind, start_t,
                  attrs=attrs)
        self._next_sid += 1
        sp.end_t = float(end_t)
        self._finish(sp)
        return sp

    def event(self, name: str, kind: str = "event", **attrs) -> Span:
        """Zero-duration marker at the current time (policy decisions,
        sheds, retries)."""
        t = self._now()
        return self.emit(name, t, t, kind=kind, **attrs)

    # -- inspection ---------------------------------------------------------
    def spans(self) -> List[Span]:
        """Finished spans, oldest first (bounded by the ring)."""
        return list(self._ring)

    def open_spans(self) -> List[Span]:
        return list(self._stack)

    def find(self, name: Optional[str] = None,
             kind: Optional[str] = None) -> List[Span]:
        return [s for s in self._ring
                if (name is None or s.name == name)
                and (kind is None or s.kind == kind)]

    # -- the conservation invariant -----------------------------------------
    def assert_matches_clock(self, clock=None) -> None:
        """Exact (``==``) per-channel agreement between charged span
        time and the clock's channel ledger.  Charged spans replay the
        clock's own float accumulation, so any mismatch means an
        advance happened outside a charged span (or a span charged
        seconds the clock never saw)."""
        clock = clock if clock is not None else self.clock
        if clock is None:
            raise ValueError("no clock to check against")
        if self._stack:
            raise AssertionError(
                f"open spans at conservation check: "
                f"{[s.name for s in self._stack]}")
        for ch in set(self.channel_seconds) | set(clock.channels):
            mine = self.channel_seconds.get(ch, 0.0)
            clk = clock.channels.get(ch, 0.0)
            if mine != clk:
                raise AssertionError(
                    f"channel {ch!r}: span time {mine!r} != clock "
                    f"spent {clk!r} (an advance escaped its span)")


# ------------------------------------------------------ global tracer ----
_ACTIVE: "NullTracer | Tracer" = NULL_TRACER


def get_tracer() -> "NullTracer | Tracer":
    """The active tracer (the no-op :data:`NULL_TRACER` by default)."""
    return _ACTIVE


def set_tracer(tracer: "NullTracer | Tracer | None"):
    """Install ``tracer`` globally (``None`` restores the no-op);
    returns the previous tracer."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else NULL_TRACER
    return prev


@contextlib.contextmanager
def use_tracer(tracer: "NullTracer | Tracer") -> Iterator:
    """Scoped :func:`set_tracer`: installs ``tracer`` for the body and
    restores the previous tracer on exit."""
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
