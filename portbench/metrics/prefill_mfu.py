"""prefill_mfu (the whole step, host clock over counted operations): the
model operations of the window's prefills (``counts/prefill.py``) over
the window's seconds times the card's bf16 peak, in %.  Moves
rows_per_s."""
from portbench.counts import prefill


def read(run):
    done = run.done()
    if not done:
        return None
    flops = sum(prefill.flops(run.cfg, q.rows, q.tokens) for q in done)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flop_per_s"])
