"""The share of the traced slice in which the device is idle while the
host is inside the program's ``train.optimizer`` span: the card waiting on
AdamW's launches. The device's idle intervals come from the profile, on
the host clock through its anchor (``spans.AnchoredTracer``). None without
spans or without a device operation in the slice."""

from portbench import spans


def read(run):
    return spans.idle_share(run, "train.optimizer")
