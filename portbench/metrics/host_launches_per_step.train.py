"""Launch API calls (kernel and graph launches) on the host per optimizer
step, from the CPU side of the traced slice's profile. A multi-tensor
AdamW moves this number."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.units
