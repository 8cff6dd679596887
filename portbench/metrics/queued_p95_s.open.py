"""The batcher's queue: the 95th percentile (nearest rank) of the seconds
from a request's ``submit`` to the worker taking it from the queue, the
program's ``batcher.queued`` span, over the requests submitted in the
window before the traced slice (joined by request id). None where the run
recorded no spans. Program span."""

from portbench import spans


def read(run):
    queued = spans.request_phase(run, "batcher.queued")
    return spans.p95([s.end - s.start for s in queued]) if queued else None
