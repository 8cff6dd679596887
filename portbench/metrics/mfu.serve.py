"""The whole synthesis's share of the card's dense bf16 peak (989
TFLOP/s; the card's power limit is in the result's ``device``): the model
work of every request of the untraced calls of the window, counted by
``arith.request_flops`` at each request's own text and speech lengths,
over those calls' host time."""

from portbench import arith


def read(run):
    calls = [c for c in run.untraced_calls() if "flops" in c]
    seconds = sum(c["end"] - c["start"] for c in calls)
    if not seconds:
        return None
    return 100.0 * sum(c["flops"] for c in calls) / seconds / arith.PEAK_FLOPS
