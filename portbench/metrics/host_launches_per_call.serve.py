"""Launch API calls (kernel and graph launches) on the host per engine
call, from the CPU side of the traced slice's profile. CUDA graphs move
this number."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.units
