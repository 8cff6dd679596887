"""The batcher's hold: the 95th percentile (nearest rank) of the seconds
from the worker taking a request to the start of the engine call that
carries it (the collect window, and any earlier chunk of the same drain),
the program's ``batcher.held`` span, over the requests submitted in the
window before the traced slice (joined by request id). None where the run
recorded no spans. Program span."""

from portbench import spans


def read(run):
    held = spans.request_phase(run, "batcher.held")
    return spans.p95([s.end - s.start for s in held]) if held else None
