"""setup_sqlite_s (store: core/store.py, program spans): the seconds
set-up spends reading pages out of SQLite, the ``get_pages`` spans from
the engine's build to the window.  Moves setup_s."""


def read(run):
    n, sec = run.setup_spans.get("get_pages", (0, 0.0))
    return sec if n else None
