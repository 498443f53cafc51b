"""Share of the traced window in which no operation ran on the card:
1 − (union of the device events' intervals) / window, in %."""


def read(run):
    trace = run.trace
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
