"""Device timing on the card and the least time the card could take.

``median_ms`` is the timing protocol of chip_smoke.py and the profiling
scripts: a device median over CUDA events, each run queued behind a ~1 ms
``torch.cuda._sleep`` so the host's time to launch it (tens of
microseconds through Python) is not counted. ``bound`` is the larger of
the bytes a function must move over the memory rate, its products over
the tensor cores' rate and its exponentials over the special-function
units' rate, at the H100 SXM's published peaks.
"""

from __future__ import annotations

import statistics

import torch

# dense bf16 tensor cores and HBM3 (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32 exponentials (ex2 on the MUFU, 16 per SM per clock: 132 SMs at
# ~1.83 GHz), the figure FlashAttention-3 gives for the H100 SXM5; ex2 on
# packed bf16x2 does two per operation
PEAK_EXP = 3.9e12


def median_ms(fn, n: int = 20) -> float:
    """Median device time (ms) of ``fn`` over ``n`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # clock cycles
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, exps: float = 0.0) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes"): ``exps`` counts MUFU
    operations (one per f32 exponential, one per bf16x2 pair); products
    and exponentials run on separate units, so the operations' time is the
    larger of the two."""
    ops_ms = max(flops / PEAK_FLOPS, exps / PEAK_EXP) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
