"""Trace exporters: Chrome-trace/Perfetto JSON and flat JSONL.

The Chrome trace format (the JSON Perfetto and ``chrome://tracing``
both load) wants ``traceEvents`` with complete ("X") events stamped in
microseconds.  Our timestamps are *virtual* seconds — we export
``ts = start_t * 1e6`` unchanged, so a 50ms SLO renders as 50ms on the
timeline even though no wall time was ever consumed.

Track layout: one track per clock channel (``channel/storage``,
``channel/compute``, ``channel/idle``), one per shard
(``shard/0`` ...), one for the per-request spans (``requests``) and
one per remaining span kind.  Track names are emitted as "M"
``thread_name`` metadata records, the shape Perfetto's schema expects.

The top-level ``otherData`` carries the clock's channel ledger and the
tracer's charged-span ledger side by side, so ``trace_report.py`` can
re-verify the conservation invariant from the file alone, without the
live objects.
"""
from __future__ import annotations

import json
from typing import Dict, List

__all__ = ["to_chrome_trace", "to_jsonl", "write_trace",
           "validate_chrome_trace", "load_trace"]

_PID = 1


def _track_name(span) -> str:
    shard = span.attrs.get("shard")
    if shard is not None:
        return f"shard/{shard}"
    if span.channel is not None:
        return f"channel/{span.channel}"
    if span.kind == "request":
        return "requests"
    return f"kind/{span.kind}"


def to_chrome_trace(tracer, clock=None) -> dict:
    """One Chrome-trace JSON object for the tracer's finished spans
    (virtual-clock microsecond timestamps)."""
    clock = clock if clock is not None else tracer.clock
    tracks: Dict[str, int] = {}
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": "repro-serving (virtual clock)"},
    }]

    def tid_for(track: str) -> int:
        tid = tracks.get(track)
        if tid is None:
            tid = len(tracks) + 1
            tracks[track] = tid
            events.append({"name": "thread_name", "ph": "M",
                           "pid": _PID, "tid": tid,
                           "args": {"name": track}})
        return tid

    for sp in tracer.spans():
        end = sp.end_t if sp.end_t is not None else sp.start_t
        args = dict(sp.attrs)
        args["sid"] = sp.sid
        if sp.parent is not None:
            args["parent"] = sp.parent
        if sp.channel is not None:
            args["channel"] = sp.channel
        if sp.charge is not None:
            args["charge"] = sp.charge
        events.append({
            "name": sp.name, "cat": sp.kind, "ph": "X", "pid": _PID,
            "tid": tid_for(_track_name(sp)),
            "ts": sp.start_t * 1e6,
            "dur": max(0.0, end - sp.start_t) * 1e6,
            "args": args,
        })

    other = {
        "tracer_channel_seconds": dict(tracer.channel_seconds),
        "dropped_spans": getattr(tracer, "dropped", 0),
    }
    if clock is not None:
        other["clock_channels"] = dict(clock.channels)
        other["clock_now"] = clock.now
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def to_jsonl(tracer) -> str:
    """Flat one-span-per-line JSON (oldest first), for ad-hoc jq /
    pandas analysis."""
    return "\n".join(json.dumps(sp.to_dict(), sort_keys=True)
                     for sp in tracer.spans()) + "\n"


def write_trace(path: str, tracer, clock=None) -> str:
    """Write the trace to ``path``: ``*.jsonl`` gets the flat form,
    anything else the Chrome-trace JSON.  Returns the path."""
    if str(path).endswith(".jsonl"):
        text = to_jsonl(tracer)
    else:
        text = json.dumps(to_chrome_trace(tracer, clock=clock),
                          indent=1, sort_keys=True)
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema check for the Chrome-trace export (used by
    ``make trace-smoke``); returns a list of problems, empty when the
    document is well-formed."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["top level is not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    tids: Dict[int, str] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unexpected phase {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                tids[ev.get("tid")] = ev["args"]["name"]
            continue
        for key in ("name", "cat", "pid", "tid", "ts", "dur"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ev.get("tid") not in tids:
            problems.append(
                f"event {i}: tid {ev.get('tid')!r} has no thread_name "
                "metadata")
        if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
            problems.append(f"event {i}: negative duration")
    other = doc.get("otherData", {})
    if not isinstance(other, dict) \
            or "tracer_channel_seconds" not in other:
        problems.append("otherData.tracer_channel_seconds missing")
    return problems


def load_trace(path: str) -> List[dict]:
    """Read a trace written by :func:`write_trace` back into a flat
    list of span dicts (either format)."""
    with open(path) as fh:
        text = fh.read()
    if str(path).endswith(".jsonl"):
        return [json.loads(line) for line in text.splitlines() if line]
    doc = json.loads(text)
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        span = {"name": ev["name"], "kind": ev.get("cat", "span"),
                "start_t": ev["ts"] / 1e6,
                "end_t": (ev["ts"] + ev["dur"]) / 1e6,
                "sid": args.pop("sid", None),
                "parent": args.pop("parent", None)}
        if "channel" in args:
            span["channel"] = args.pop("channel")
        if "charge" in args:
            span["charge"] = args.pop("charge")
        span["attrs"] = args
        out.append(span)
    return out
