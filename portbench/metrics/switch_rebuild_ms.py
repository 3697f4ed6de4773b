"""switch_rebuild_ms (engine: serving/engine.py, program spans): the mean
``switch_rebuild`` span of the window's model switches, the model's
parameters rebuilt from its tensors, in ms.  Moves rows_per_s."""


def read(run):
    n, sec = run.spans.get("switch_rebuild", (0, 0.0))
    return sec / n * 1e3 if n else None
