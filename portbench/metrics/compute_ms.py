"""compute_ms (model: models/transformer.py, host clock): the mean of
``LMServingEngine._compute`` (``prefill`` and the tokens to the host, so
the device work is inside) over the window's queries.  Moves
rows_per_s."""


def read(run):
    s = run.compute_s
    return sum(s) / len(s) * 1e3 if s else None
