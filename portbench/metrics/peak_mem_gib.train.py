"""The most device memory allocated during the window
(``max_memory_allocated`` after a reset at its start), in GiB."""


def read(run):
    if "window_peak_bytes" not in run.extra:
        return None
    return run.extra["window_peak_bytes"] / 2**30
