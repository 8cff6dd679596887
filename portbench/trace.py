"""One traced slice of a run's window, reduced to what the metrics read.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) from
``start`` to ``stop``; the slice is synchronized at both ends, so every
device operation in it belongs to the work the slice launched. ``Slice``
keeps:

- ``window_s``: the slice's length on the host clock;
- ``busy_s``: the union of the device operations' intervals (kernels,
  copies and sets), so overlapping kernels count once;
- ``kernels``: ``{name: [seconds, count]}`` of the device operations;
- ``launches``: the host's launch API calls (kernel and graph launches);
- ``gaps``: the device's longest idle intervals, each labelled with the
  innermost host operation in flight at its middle.

The spans' copies on the device's timeline (user annotations) are left
out of the device's operations.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
               "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    kernels: dict
    launches: int
    gaps: list
    units: int = 0  # engine calls or optimizer steps inside the slice

    def time_of(self, patterns: tuple[str, ...]) -> tuple[float, int]:
        """Device seconds and count of the operations whose names contain
        one of ``patterns``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if any(p in name for p in patterns):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[name[:160], sec] for name, (sec, _) in ops],
                "idle_gaps": [[label[:160], sec] for label, sec in gaps]}


def _union(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(total length, merged intervals) of ``intervals``."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def reduce_events(events, window_s: float) -> Slice:
    """A ``Slice`` from the profiler's ``FunctionEvent`` list (times in us)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):  # a span's copy is no operation
                device.append(e)
        else:
            host.append(e)
    kernels: dict[str, list] = {}
    for e in device:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) * 1e-6
        k[1] += 1
    busy_us, merged = _union([(e.time_range.start, e.time_range.end) for e in device])
    launches = sum(1 for e in host if e.name in LAUNCH_APIS)
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                  if not e.name.startswith("cu")), key=lambda o: o[0])
    starts = [o[0] for o in ops]
    longest = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                     reverse=True)[:10]
    gaps = []
    for length, a, b in longest:
        mid = 0.5 * (a + b)
        label, best = "idle (no host op)", None
        for s, t, name in ops[:bisect.bisect_right(starts, mid)]:
            if t >= mid and (best is None or t - s < best):
                label, best = name, t - s
        gaps.append((label, length * 1e-6))
    return Slice(window_s=window_s, busy_s=busy_us * 1e-6, kernels=kernels, launches=launches,
                 gaps=gaps)


class Tracer:
    """``start()`` ... ``stop(units)`` around a slice of the window; the
    profile is reduced (``result()``) only when asked, after the window, so
    the reduction's host time falls outside what the window measures."""

    def __init__(self):
        self.prof = None
        self.t0 = self.window_s = 0.0
        self.units = 0
        self._slice: Slice | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.units = units

    def result(self) -> Slice:
        if self._slice is None:
            self._slice = reduce_events(self.prof.events(), self.window_s)
            self._slice.units = self.units
            self.prof = None
        return self._slice
