"""What the profiler saw in the window: device busy time, time by device
operation, and the device's idle time split by the host's phase.

The harness marks the window and the host's phases with
``record_function("phase:<name>")`` ranges: ``client`` (drawing the
next query), ``engine`` (``submit`` and ``run``), and inside it
``switch`` (``_load_model``) and ``compute`` (``_compute``).  A stretch
of the window in which no device operation runs is idle; each idle
stretch is charged to the innermost phase the host was in, or to
``outside`` (the loop's own bookkeeping).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

Interval = Tuple[float, float]

#: the program's ``flash_attention`` kernels (both bodies)
FLASH_KERNELS = ("flash_wgmma_kernel", "flash_attention_kernel")


def _merge(spans: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _leaf_phases(phases: List[Tuple[float, float, str]]
                 ) -> Tuple[List[float], List[str]]:
    """The timeline cut into pieces, each named by the innermost phase
    covering it (ranges nest), ``outside`` where none does: (the start of
    each piece, its name); a piece runs to the next one's start."""
    starts, names, stack, cur = [], [], [], float("-inf")

    def piece(until: float, name: str) -> None:
        nonlocal cur
        starts.append(cur)
        names.append(name)
        cur = until

    for a, b, n in sorted(phases, key=lambda p: (p[0], -p[1])):
        while stack and stack[-1][0] <= a:
            end, name = stack.pop()
            piece(end, name)
        piece(a, stack[-1][1] if stack else "outside")
        stack.append((b, n))
    while stack:
        end, name = stack.pop()
        piece(end, name)
    piece(float("inf"), "outside")
    return starts, names


def _charge(gaps: List[Interval], starts: List[float], names: List[str]
            ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for a, b in gaps:
        i, t = bisect.bisect_right(starts, a) - 1, a
        while t < b:
            nxt = min(b, starts[i + 1] if i + 1 < len(starts) else b)
            if nxt > t:
                out[names[i]] = out.get(names[i], 0.0) + (nxt - t)
                t = nxt
            i += 1
    return out


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: Dict[str, List[float]]        # device op name -> [seconds, count]
    idle: Dict[str, float]             # host phase -> idle seconds

    def kernel(self, names=FLASH_KERNELS) -> Tuple[float, int]:
        """(seconds, launches) of the device ops whose name holds one of
        ``names``."""
        hits = [v for k, v in self.ops.items() if any(n in k for n in names)]
        return sum(v[0] for v in hits), int(sum(v[1] for v in hits))

    def breakdown(self) -> Dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:96], v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _events(prof):
    """(name, device type, start s, end s) of every profiled event, from
    the profiler's raw records: building its ``FunctionEvent`` tree takes
    a minute for a million events, the raw read a second."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        for e in prof.events():
            yield (e.name, e.device_type.name, e.time_range.start * 1e-6,
                   e.time_range.end * 1e-6)
        return
    for e in results.events():
        yield (e.name(), e.device_type().name, e.start_ns() * 1e-9,
               e.end_ns() * 1e-9)


def summarize(prof) -> Summary:
    """Read a finished ``torch.profiler.profile`` of the window."""
    device, phases, window = [], [], None
    for name, kind, a, b in _events(prof):
        if name.startswith("phase:"):
            if kind != "CPU":                 # its span on the device's
                continue                      # timeline is no device work
            if name == "phase:window":
                window = (a, b)
            else:
                phases.append((a, b, name[len("phase:"):]))
        elif kind == "CUDA":
            device.append((a, b, name))
    if window is None:
        raise RuntimeError("the profile holds no phase:window range")
    lo, hi = window
    ops: Dict[str, List[float]] = {}
    spans = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        rec = ops.setdefault(name, [0.0, 0])
        rec[0] += b - a
        rec[1] += 1
    busy = _merge(spans)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    starts, names = _leaf_phases(phases)
    return Summary(window_s=hi - lo, busy_s=sum(b - a for a, b in busy),
                   ops=ops, idle=_charge(gaps, starts, names))
