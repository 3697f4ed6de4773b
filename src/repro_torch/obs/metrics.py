"""One enumerable metrics registry over the stack's stats surfaces.

``ServeStats``, ``RecoveryStats``, the pool / transfer / router
counters and the virtual clock each grew their own ad-hoc attribute
surface across PRs 1-8.  :class:`MetricsRegistry` unifies them without
touching that attribute API: a metric is a *view* — a name, a kind and
a zero-arg callable that reads the live object — so registering is
free, values are never copied until :meth:`snapshot`, and the existing
dataclasses stay the single source of truth.

Kinds:

  * ``counter`` — monotone scalar (requests served, pages fetched);
    :meth:`diff` subtracts snapshots.
  * ``gauge`` — instantaneous scalar or ``{label: value}`` mapping
    (clock channels, slab occupancy).
  * ``histogram`` — a list of float samples; snapshots summarize to
    ``{count, mean, p50, p99}`` (nearest-rank, matching
    ``ServeStats.percentile``).

Names are dotted ``namespace.field`` (``serve.requests``,
``faults.retries``, ``clock.idle``); ``launch/serve.py
--report-json`` dumps a snapshot, and the report-line audit test pins
every registered serve counter to exactly one ``[report]`` line.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

__all__ = ["MetricsRegistry"]

_KINDS = ("counter", "gauge", "histogram")


def _percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile, same convention as
    ``ServeStats.percentile`` (q in [0, 100])."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = max(0, min(len(xs) - 1, int(round(q / 100.0 * len(xs))) - 1))
    return float(xs[idx])


class _Metric:
    __slots__ = ("name", "kind", "read", "help")

    def __init__(self, name: str, kind: str, read: Callable[[], object],
                 help: str = ""):
        self.name = name
        self.kind = kind
        self.read = read
        self.help = help


class MetricsRegistry:
    """Ordered name -> metric-view table with snapshot/diff."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    # -- registration -------------------------------------------------------
    def register(self, name: str, kind: str,
                 read: Callable[[], object], help: str = "") -> None:
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}; "
                             f"have {_KINDS}")
        if name in self._metrics:
            raise ValueError(f"metric {name!r} already registered")
        self._metrics[name] = _Metric(name, kind, read, help)

    def counter(self, name: str, read: Callable[[], object],
                help: str = "") -> None:
        self.register(name, "counter", read, help)

    def gauge(self, name: str, read: Callable[[], object],
              help: str = "") -> None:
        self.register(name, "gauge", read, help)

    def histogram(self, name: str, read: Callable[[], object],
                  help: str = "") -> None:
        self.register(name, "histogram", read, help)

    def register_object(self, namespace: str, obj, fields,
                        help_prefix: str = "") -> None:
        """Register dataclass-style ``fields`` of ``obj`` under
        ``namespace.``: numeric attrs become counters, list attrs
        histograms, dict attrs gauges."""
        for f in fields:
            name = f"{namespace}.{f}"
            val = getattr(obj, f)
            read = (lambda o=obj, a=f: getattr(o, a))
            if isinstance(val, list):
                self.histogram(name, read, help_prefix)
            elif isinstance(val, dict):
                self.gauge(name, read, help_prefix)
            else:
                self.counter(name, read, help_prefix)

    # -- enumeration --------------------------------------------------------
    def names(self, kind: Optional[str] = None) -> List[str]:
        return [m.name for m in self._metrics.values()
                if kind is None or m.kind == kind]

    def kind(self, name: str) -> str:
        return self._metrics[name].kind

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Materialize every view.  Histograms summarize to
        ``{count, mean, p50, p99}``; gauges backed by dicts copy the
        mapping; everything else reads as a plain number."""
        out: Dict[str, object] = {}
        for m in self._metrics.values():
            val = m.read()
            if m.kind == "histogram":
                xs = [float(x) for x in val]
                out[m.name] = {
                    "count": len(xs),
                    "mean": (sum(xs) / len(xs)) if xs else 0.0,
                    "p50": _percentile(xs, 50.0),
                    "p99": _percentile(xs, 99.0),
                }
            elif isinstance(val, dict):
                out[m.name] = {str(k): float(v) for k, v in val.items()}
            else:
                out[m.name] = float(val)
        return out

    def diff(self, before: Dict[str, object],
             after: Optional[Dict[str, object]] = None
             ) -> Dict[str, float]:
        """Counter deltas between two snapshots (``after`` defaults to
        a fresh :meth:`snapshot`); gauges and histograms are skipped —
        they are not monotone."""
        if after is None:
            after = self.snapshot()
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            if m.kind != "counter":
                continue
            if m.name in before and m.name in after:
                out[m.name] = float(after[m.name]) - float(before[m.name])
        return out
