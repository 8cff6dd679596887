"""Tracing and timing hooks (port of edm_tts_tpu/utils/profiling.py on
``torch.profiler``).

``trace`` captures a Chrome trace of the block (host ops and, on the card,
its kernels) into a directory; ``step_annotation`` names one training step
in it, as the JAX trainers' ``StepTraceAnnotation`` does (the port's
trainer wraps every step in one); ``timed`` logs a block's wall time,
optionally after waiting for the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from edm_tts_tpu_torch.utils.logging import logger

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('exp/prof'): step(...)`` writes
    ``exp/prof/trace.json`` (open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)


def step_annotation(name: str, step: int):
    """Annotate one training step for the trace viewer: a range named
    ``"<name> step <step>"``."""
    return torch.profiler.record_function(f"{name} step {step}")


@contextlib.contextmanager
def timed(name: str, sync: bool = False):
    """Host wall-clock scope timer; with ``sync`` it waits for the card's
    outstanding work before reading the clock."""
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    logger.info("%s: %.1f ms", name, (time.perf_counter() - t0) * 1e3)
