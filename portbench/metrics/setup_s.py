"""Set-up: from the process's start to the first timed request or step
(weights, engine or trainer, warm-up at the cell's shapes, and the kernel
library's build where the checkout has none yet). Host clock."""


def read(run):
    return run.setup_s
