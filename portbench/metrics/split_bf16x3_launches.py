"""split_bf16x3_launches (kernels: kernels/ops.py, program counter): the
``split_bf16x3`` kernel's launches a query over the window, from the
program's launch counts.  Moves rows_per_s."""

COUNTERS = ("repro_torch.kernels.ops:LAUNCHES",)


def read(run):
    launches = run.counters.get(COUNTERS[0])
    if launches is None or "split_bf16x3" not in launches \
            or not run.queries:
        return None
    return launches["split_bf16x3"] / len(run.queries)
