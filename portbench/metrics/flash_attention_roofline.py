"""flash_attention_roofline (kernels: kernels/ops.py, device trace): the
least time the window's ``flash_attention`` calls could take at the
card's peaks (``counts/flash_attention.py``: the larger of operations
over the bf16 rate and bytes over HBM bandwidth, call by call) over the
device time of the kernel in the trace, in %.  Every query launches one
call a layer in layer order, so the trace's launches map onto the
calls; where their numbers differ, nothing is read.  Moves rows_per_s."""
from portbench.counts import flash_attention as fa


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel()
    done = run.done()
    if not launches or not done:
        return None
    per_query = [fa.calls(run.cfg, q.rows, q.tokens) for q in done]
    bounds = [fa.bound_seconds(f, b, run.peaks) for calls in per_query
              for f, b in calls]
    if launches != len(bounds):
        return None
    return 100.0 * sum(bounds) / seconds
