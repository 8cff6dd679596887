"""The device's idle share of the traced slice: one minus the union of
its operations' intervals over the slice's length, both from one
profile."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
