"""setup_fault_s (store to device pool: serving/transfer.py, program
spans): the seconds set-up spends faulting pages from the store into the
device slab, the ``load_group`` and ``page_load`` spans from the engine's
build to the window.  Moves setup_s."""


def read(run):
    s = [run.setup_spans[k] for k in ("load_group", "page_load")
         if k in run.setup_spans]
    return sum(sec for _, sec in s) if s else None
