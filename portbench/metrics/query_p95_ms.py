"""query_p95_ms (end to end, host clock): the 95th percentile, over every
query finished in the window, of submit to tokens on the host."""
import numpy as np


def read(run):
    lat = [q.end - q.start for q in run.done()]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
