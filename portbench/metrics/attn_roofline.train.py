"""Kernels K3 and K4 (``csrc/attention.cu``, ``csrc/attention_bwd.cu``):
the least time of the attention forward with its LSE and backward at each
traced step's shapes (``arith.attention_fwd_bwd_least_s``, every layer of
every micro-batch), over the device time of the kernels named below in the
traced slice."""

KERNELS = ("attn_fwd_kernel", "dkv_kernel", "dq_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.time_of(KERNELS)
    least = sum(c.get("attn_least_s", 0.0) for c in run.calls if c.get("traced"))
    return 100.0 * least / seconds if count and least else None
