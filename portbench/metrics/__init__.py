"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

Each module defines ``read(run) -> float | None`` over a
``harness.Run``; ``None`` leaves the metric out of the result line.
"""
