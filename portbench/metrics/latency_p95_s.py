"""The 95th percentile (nearest rank) of the latency of every request due
in the window, each from when it was due to when its waveform came back;
a request that failed, was refused or never came counts as infinitely
late. Host clock."""

import math


def p95(values):
    values = sorted(values)
    return values[max(0, math.ceil(0.95 * len(values)) - 1)]


def read(run):
    if not run.requests:
        return None
    return p95([r["done"] - r["due"] if r["done"] is not None else math.inf
                for r in run.requests])
