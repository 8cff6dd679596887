"""The mean number of real rows per engine call in the window (the
batcher's grouping; the engine pads each call to its batch bucket), from
the benchmark's wrapper around ``synth_fn``; the calls the traced slice
holds up are left out. Program counter."""


def read(run):
    calls = [c for c in run.untraced_calls() if "rows" in c]
    if not calls:
        return None
    return sum(c["rows"] for c in calls) / len(calls)
