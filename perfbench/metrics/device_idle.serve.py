"""The share of the window in which no operation ran on the card: the
window less the union of the device operations' intervals (the profiler's
trace), over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
