"""The share of the traced slice in which the device is idle while the
batcher's worker is inside ``batcher.collect`` (waiting for a first
request, then the collect window): idle for want of work, as against idle
while the host works. The device's idle intervals come from the profile,
on the host clock through its anchor (``spans.AnchoredTracer``). None
without spans or without a device operation in the slice."""

from portbench import spans


def read(run):
    return spans.idle_share(run, "batcher.collect")
