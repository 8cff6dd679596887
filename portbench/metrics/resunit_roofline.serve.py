"""Kernel K1 (``csrc/resunit.cu``): the least time of the decoder's
residual units (the dilated k=7 and the k=1 convolution, C x C each) at
the shapes the traced calls launched them at (``arith.resunit_launches``,
cross-checked against the port's ``resunit_shapes`` in set-up), over the
device time of the kernels named below (the unit's snake pass and its two
products) in the traced slice."""

KERNELS = ("resunit_gemm_kernel", "snake_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.time_of(KERNELS)
    least = sum(c.get("resunit_least_s", 0.0) for c in run.calls if c.get("traced"))
    return 100.0 * least / seconds if count and least else None
