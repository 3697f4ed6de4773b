"""device_idle_pct (device, device trace): the share of the traced window
in which no device operation runs, in %.  Moves rows_per_s."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
