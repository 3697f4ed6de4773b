"""switch_ms (engine: serving/engine.py, host clock): the mean of
``LMServingEngine._load_model`` over the window's switches to another
variant, each ending in a device synchronize (the page accesses,
``device_tensor`` and ``rebuild``).  Moves rows_per_s."""


def read(run):
    s = run.switch_s
    return sum(s) / len(s) * 1e3 if s else None
