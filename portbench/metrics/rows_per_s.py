"""rows_per_s (end to end, host clock): every row whose tokens reached the
host in the window, over the window's seconds (the first submit to the
last query's return)."""


def read(run):
    return sum(q.rows for q in run.done()) / run.window_s
