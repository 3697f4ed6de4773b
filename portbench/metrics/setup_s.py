"""setup_s (end to end, host clock): process start to the first timed
query: imports, CUDA set-up, the store opened (or built on a checkout's
first run), the engine and its slab, the warm-up queries with the first
switches to every variant."""


def read(run):
    return run.setup_s
