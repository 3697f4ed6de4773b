"""Wall-clock tracing: the port's tracer where the work itself is timed.

:mod:`repro_torch.obs.trace` is a verbatim copy of the reference's
virtual-clock tracer; this module extends it for the card:

  * :class:`WallClock` — ``time.perf_counter()`` seconds as a tracer's
    clock.  Nothing is charged to it, so its ``channels`` ledger stays
    empty (the exporter and :meth:`Tracer.assert_matches_clock` read it
    all the same).
  * :class:`WallTracer` — a :class:`~repro_torch.obs.trace.Tracer` on a
    :class:`WallClock` that keeps per-name :attr:`WallTracer.totals`
    past the ring's eviction and, with ``profile=True``, opens a
    ``torch.profiler.record_function("span:<name>")`` range around every
    span opened through :meth:`WallTracer.span`, so that the spans lie
    on a ``torch.profiler`` timeline beside the device's kernels.

Tracing stays off until a caller installs a tracer (``set_tracer`` /
``use_tracer``); the default remains the shared ``NULL_TRACER``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from .trace import Span, Tracer

__all__ = ["WallClock", "WallTracer"]


class WallClock:
    """The wall clock as a tracer's time source."""

    __slots__ = ("channels",)

    def __init__(self):
        self.channels: Dict[str, float] = {}

    @property
    def now(self) -> float:
        return time.perf_counter()


class _RangedHandle:
    """A span's handle and its profiler range: closes the span, then the
    range, even when the body raises."""

    __slots__ = ("_handle", "_range")

    def __init__(self, handle, range_):
        self._handle = handle
        self._range = range_

    def __enter__(self) -> Span:
        return self._handle.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            return self._handle.__exit__(exc_type, exc, tb)
        finally:
            self._range.__exit__(exc_type, exc, tb)


class WallTracer(Tracer):
    """A :class:`Tracer` on the wall clock (``clock`` defaults to a
    :class:`WallClock`).

    :attr:`totals` maps a span name to ``(count, seconds)`` over every
    span of that name finished so far, evicted ones included: a reader
    takes the difference of two snapshots (``dict(tracer.totals)``).
    ``profile``: also open ``torch.profiler.record_function(
    "span:<name>")`` around every span opened through :meth:`span`."""

    def __init__(self, clock=None, ring: int = 65536,
                 profile: bool = False):
        super().__init__(WallClock() if clock is None else clock, ring)
        self.totals: Dict[str, Tuple[int, float]] = {}
        self._record = None
        if profile:
            import torch
            self._record = torch.profiler.record_function

    def _finish(self, sp: Span) -> None:
        count, seconds = self.totals.get(sp.name, (0, 0.0))
        self.totals[sp.name] = (count + 1, seconds + sp.duration)
        super()._finish(sp)

    def span(self, name: str, kind: str = "span",
             channel: Optional[str] = None,
             charge: Optional[float] = None, **attrs):
        handle = super().span(name, kind=kind, channel=channel,
                              charge=charge, **attrs)
        if self._record is None:
            return handle
        range_ = self._record(f"span:{name}")
        range_.__enter__()
        return _RangedHandle(handle, range_)
