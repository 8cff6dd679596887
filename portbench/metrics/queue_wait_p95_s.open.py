"""The batcher's wait: the 95th percentile (nearest rank) over the
window's requests of the time from when each was due to the start of the
engine call that carried it, from the benchmark's wrapper around the
``synth_fn`` it hands ``DynamicBatcher``; the requests the traced slice
holds up are left out. A request no call carried counts as infinitely
late. Program span (the wrapper's clock)."""

import math


def read(run):
    if not run.requests:
        return None
    waits = sorted(r["start"] - r["due"] if r["start"] is not None else math.inf
                   for r in run.requests if not r.get("traced"))
    return waits[max(0, math.ceil(0.95 * len(waits)) - 1)]
