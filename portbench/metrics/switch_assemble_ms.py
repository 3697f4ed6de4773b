"""switch_assemble_ms (engine: serving/engine.py, program spans): the mean
``switch_assemble`` span of the window's model switches, each tensor put
together on the device from slab blocks (``device_tensor``), in ms.
Moves rows_per_s."""


def read(run):
    n, sec = run.spans.get("switch_assemble", (0, 0.0))
    return sec / n * 1e3 if n else None
