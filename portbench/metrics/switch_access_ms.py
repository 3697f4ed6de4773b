"""switch_access_ms (engine: serving/engine.py, program spans): the mean
``switch_access`` span of the window's model switches, the pool's page
accesses (its ``pool_group`` inside), in ms.  Moves rows_per_s."""


def read(run):
    n, sec = run.spans.get("switch_access", (0, 0.0))
    return sec / n * 1e3 if n else None
