"""Kernel K5 (``csrc/qdense.cu``): the least time of the int8 linears'
work at the shapes the traced calls launched them at
(``arith.int8_launches``, cross-checked against the port's
``int8_dense_shapes`` in set-up), over the device time of the kernels
named below in the traced slice."""

KERNELS = ("int8_dense_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.time_of(KERNELS)
    least = sum(c.get("int8_least_s", 0.0) for c in run.calls if c.get("traced"))
    return 100.0 * least / seconds if count and least else None
