"""Device timing on the card and the least time the card could take.

``median_ms`` is the timing protocol of chip_smoke.py and the profiling
scripts: a device median over CUDA events, each run queued behind a ~1 ms
``torch.cuda._sleep`` so the host's time to launch it (tens of
microseconds through Python) is not counted. ``bound`` is the larger of
the bytes a function must move over the memory rate, its products over
the tensor cores' rate and its exponentials over the special-function
units' rate, at the H100 SXM's published peaks (f32-accurate products at
the split-TF32 rates below).
"""

from __future__ import annotations

import statistics

import torch

# dense bf16 tensor cores and HBM3 (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# dense TF32 tensor cores (the data sheet's "TF32", without sparsity)
PEAK_TF32_FLOPS = 495e12
# f32-accurate products on them: an f32 product as three TF32 products of
# split operands (hi*hi + hi*lo + lo*hi, "3xTF32": K3's and K4's f32
# kernels), or as two where one operand is exact in TF32 (x_hi*W + x_lo*W
# with an int8 weight W, "2xTF32": K5's f32 kernel). The least time of the
# same f32-accurate work on this card, so the f32 kernels' bound.
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_2XTF32_FLOPS = PEAK_TF32_FLOPS / 2
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


def bound(flops: float, nbytes: float, exps: float = 0.0,
          peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes"): ``exps`` counts MUFU
    operations (one per f32 exponential, one per bf16x2 pair); products
    and exponentials run on separate units, so the operations' time is the
    larger of the two. ``peak_flops``: the products' rate (PEAK_3XTF32_FLOPS
    or PEAK_2XTF32_FLOPS for f32-accurate products)."""
    ops_ms = max(flops / peak_flops, exps / PEAK_EXP) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
