"""The training step's share of the card's dense bf16 peak (989 TFLOP/s;
the card's power limit is in the result's ``device``): three times the
trainable forward's work plus the frozen codec's, by
``arith.s2a_train_flops`` for the recipe's batch, over the untraced steps'
host time."""

from portbench import arith


def read(run):
    steps = [c for c in run.untraced_calls() if "flops" in c]
    seconds = sum(c["end"] - c["start"] for c in steps)
    if not seconds:
        return None
    return 100.0 * sum(c["flops"] for c in steps) / seconds / arith.PEAK_FLOPS
