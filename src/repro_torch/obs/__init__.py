"""Observability for the dedup serving stack (DESIGN.md §10).

Three pieces, all on the virtual clock:

  * :mod:`repro.obs.trace` — nested spans with named-channel charge
    accounting.  The default tracer is a zero-allocation no-op, so the
    serving hot path pays one ``get_tracer()`` attribute hop when
    tracing is off.
  * :mod:`repro.obs.metrics` — one enumerable :class:`MetricsRegistry`
    over the stats dataclasses (``ServeStats``, ``RecoveryStats``,
    pool / transfer / router counters) that were previously N
    disconnected ad-hoc surfaces.
  * :mod:`repro.obs.export` — Chrome-trace/Perfetto JSON and flat
    JSONL exporters plus schema validation for CI.

The load-bearing invariant: a charged span records *the same float*
that was passed to ``VirtualClock.advance``, accumulated in the same
order, so per-channel span time equals ``VirtualClock.spent`` per
channel **exactly** — tracing is a second, independent witness of the
clock discipline.
"""
from .trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    use_tracer,
)
from .metrics import MetricsRegistry
from .export import (
    to_chrome_trace,
    to_jsonl,
    validate_chrome_trace,
    write_trace,
)

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "use_tracer",
    "MetricsRegistry",
    "to_chrome_trace",
    "to_jsonl",
    "validate_chrome_trace",
    "write_trace",
]
