"""The optimizer's seconds a step: the program's ``train.optimizer``
spans (``AdamW.apply``, whose clipping test waits for the step's device
backlog) inside the untraced ``train.step`` spans, over their number. None
where the run recorded no spans. Program span."""

from portbench import spans


def read(run):
    found = spans.inside(run, "train.optimizer", "train.step")
    if not found or not found[0]:
        return None
    steps, phases = found
    return sum(s.end - s.start for s in phases) / len(steps)
