"""The t2s stage's seconds a call: the mean of the program's
``engine.t2s`` spans (to the copy of the lengths to the host, so the
stage's device time) whose ``engine.synthesize`` is untraced. None where
the run recorded no spans. Program span."""

from portbench import spans


def read(run):
    found = spans.inside(run, "engine.t2s", "engine.synthesize")
    if not found or not found[1]:
        return None
    return sum(s.end - s.start for s in found[1]) / len(found[1])
