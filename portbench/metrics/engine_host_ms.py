"""engine_host_ms (engine: serving/engine.py, program spans): the engine's
own host work a query over the window: the ``lm_submit`` and ``lm_batch``
spans less the ``lm_load`` and ``lm_compute`` spans they hold, over the
window's ``lm_submit`` spans, in ms.  Moves rows_per_s."""


def read(run):
    s = run.spans
    n = s.get("lm_submit", (0, 0.0))[0]
    if not n or "lm_batch" not in s:
        return None
    sec = {k: s.get(k, (0, 0.0))[1]
           for k in ("lm_submit", "lm_batch", "lm_load", "lm_compute")}
    own = sec["lm_submit"] + sec["lm_batch"] - sec["lm_load"] \
        - sec["lm_compute"]
    return own / n * 1e3
