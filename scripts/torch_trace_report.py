#!/usr/bin/env python
"""Per-request critical-path report over a trace written by the
PyTorch / CUDA port's ``--trace``: the port's counterpart of
scripts/trace_report.py, reading the file through ``repro_torch.obs``.

Reads a Chrome-trace (.json) or flat JSONL (.jsonl) trace from
``python -m repro_torch.launch.serve --trace`` and prints:

  * a per-request stage attribution table: queue / fetch / compute at
    p50 and p99 (nearest-rank, matching ``ServeStats.percentile``),
  * the critical-path breakdown of the p99-latency request — its stage
    sum is checked EXACTLY equal to its reported latency (the spans
    carry residual-split stage times, so float addition cannot leak),
  * the channel-conservation proof re-verified from the file alone:
    per-channel charged-span seconds == the clock's channel ledger.

Exit status is non-zero when any exact identity fails, so a
tracer regression hard-fails.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.obs.export import load_trace     # noqa: E402

STAGES = ("queue_s", "fetch_s", "compute_s")


def _nearest_rank(xs, q):
    """Nearest-rank percentile over a non-empty sorted copy."""
    xs = sorted(xs)
    idx = max(0, min(len(xs) - 1, int(round(q / 100.0 * len(xs))) - 1))
    return xs[idx]


def _requests(spans):
    """The served (non-shed) request spans, as attr dicts + names."""
    out = []
    for sp in spans:
        if sp.get("kind") != "request":
            continue
        at = sp.get("attrs", {})
        if at.get("shed"):
            continue
        out.append(at)
    return out


def check_request_identities(reqs) -> list:
    """The residual-split stage identities, exact per request:
    queue+service == latency and fetch+compute == service.  Returns
    human-readable problem strings (empty = all exact)."""
    problems = []
    for at in reqs:
        rid = at.get("rid")
        q, s = at.get("queue_s"), at.get("service_s")
        f, c = at.get("fetch_s"), at.get("compute_s")
        lat = at.get("latency_s")
        if None in (q, s, f, c, lat):
            problems.append(f"rid={rid}: missing stage attrs")
            continue
        if q + s != lat:
            problems.append(
                f"rid={rid}: queue_s+service_s != latency_s "
                f"({q!r} + {s!r} != {lat!r})")
        if f + c != s:
            problems.append(
                f"rid={rid}: fetch_s+compute_s != service_s "
                f"({f!r} + {c!r} != {s!r})")
    return problems


def check_conservation(other) -> list:
    """Per-channel charged-span seconds vs the clock ledger, exact.
    ``other`` is the Chrome export's ``otherData`` (JSONL traces carry
    no ledger — the caller skips this check)."""
    problems = []
    span_ch = other.get("tracer_channel_seconds", {})
    clock_ch = other.get("clock_channels")
    if clock_ch is None:
        return problems
    for ch, booked in span_ch.items():
        spent = clock_ch.get(ch)
        if spent is None:
            problems.append(f"channel {ch!r}: charged in spans, "
                            "absent from the clock ledger")
        elif booked != spent:
            problems.append(f"channel {ch!r}: span time {booked!r} != "
                            f"clock spent {spent!r}")
    return problems


def attribution_table(reqs) -> str:
    lats = [at["latency_s"] for at in reqs]
    lines = ["stage        p50_ms      p99_ms    mean_ms"]
    for key in STAGES + ("latency_s",):
        xs = [at[key] for at in reqs]
        lines.append(f"{key.removesuffix('_s'):<10} "
                     f"{_nearest_rank(xs, 50) * 1e3:>9.3f}ms "
                     f"{_nearest_rank(xs, 99) * 1e3:>9.3f}ms "
                     f"{sum(xs) / len(xs) * 1e3:>8.3f}ms")
    p99 = _nearest_rank(lats, 99)
    worst = next(at for at in reqs if at["latency_s"] == p99)
    lines.append("")
    lines.append(f"p99 critical path (rid={worst.get('rid')}, "
                 f"model={worst.get('model')}):")
    for key in STAGES:
        frac = worst[key] / p99 if p99 else 0.0
        lines.append(f"  {key.removesuffix('_s'):<9} "
                     f"{worst[key] * 1e3:>9.3f}ms  {frac:>6.1%}")
    lines.append(f"  {'total':<9} {p99 * 1e3:>9.3f}ms  "
                 f"(== latency: "
                 f"{(worst['queue_s'] + worst['service_s']) == p99})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="trace file (.json Chrome form with "
                                  "otherData, or flat .jsonl)")
    args = ap.parse_args(argv)

    spans = load_trace(args.trace)
    reqs = _requests(spans)
    print(f"# {args.trace}: {len(spans)} spans, "
          f"{len(reqs)} served requests")
    if not reqs:
        print("no request spans; nothing to attribute")
        return 0

    problems = check_request_identities(reqs)

    if str(args.trace).endswith(".jsonl"):
        print("# (.jsonl trace: no otherData ledger; conservation "
              "check skipped)")
    else:
        import json
        with open(args.trace) as fh:
            other = json.load(fh).get("otherData", {})
        problems += check_conservation(other)
        dropped = other.get("dropped_spans", 0)
        if dropped:
            print(f"# WARNING: ring dropped {dropped} spans; "
                  "attribution covers the retained tail only")

    print(attribution_table(reqs))

    slo = sum(1 for at in reqs if at.get("slo_miss"))
    print(f"\nrequests={len(reqs)} slo_misses={slo}")

    if problems:
        print(f"\n{len(problems)} exact-identity FAILURES:",
              file=sys.stderr)
        for p in problems:
            print(f"  {p}", file=sys.stderr)
        return 1
    print("exact identities OK: queue+service==latency, "
          "fetch+compute==service, span channels == clock ledger")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
