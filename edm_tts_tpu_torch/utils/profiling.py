"""Spans and traces: the port's one tracing system (its ``trace`` is the
port of edm_tts_tpu/utils/profiling.py on ``torch.profiler``).

``span(name, **counts)`` marks one phase of the program where the work
happens (the batcher's request phases, the engine's stages, the trainer's
phases; each call site's name says which). Recording is off by default:
``span`` then returns one shared no-op context after a single check and
records nothing. Inside ``recording()`` every span appends a ``Span`` to the
log that ``recording`` yields (bounded; what it cannot hold is counted in
``dropped``) and opens a ``torch.profiler.record_function`` range of the
same name, so any profile that captures the thread shows it. A span's
parent is the innermost span open on its thread. ``add_span`` records an
interval whose ends were stamped elsewhere (a request's time in the queue,
stamped on the client's thread and on the worker's).

Times are ``time.perf_counter()`` seconds. A span times the host: it adds
no synchronization, so a span that ends in a copy to the host holds the
device's work up to that copy, and any other holds the time the host took
to enqueue its work.

``trace(log_dir)`` records spans and profiles its block (host operations of
every thread where the installed torch can, and the card's kernels) into a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch

from edm_tts_tpu_torch.utils.logging import logger

TRACE_NAME = "trace.json"
LOG_LIMIT = 200_000  # spans a log holds


class Span(NamedTuple):
    id: int
    name: str
    thread: int
    start: float
    end: float
    parent: int | None
    requests: tuple
    counts: dict


class SpanLog:
    """The spans recorded while ``recording()`` was on, oldest first."""

    def __init__(self):
        self.spans: list[Span] = []
        self.limit = LOG_LIMIT
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._open = threading.local()  # each thread's stack of open span ids

    def stack(self) -> list[int]:
        s = getattr(self._open, "ids", None)
        if s is None:
            s = self._open.ids = []
        return s

    def new_id(self) -> int:
        return next(self._ids)  # atomic under the interpreter lock

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.limit:
                self.spans.append(span)
            else:
                self.dropped += 1

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


_log: SpanLog | None = None  # the log ``recording()`` opened; None: off
_OFF = contextlib.nullcontext()


class _Open:
    """One recorded span; ``counts`` may be added to inside the block."""

    __slots__ = ("log", "name", "requests", "counts", "id", "parent", "start", "_range")

    def __init__(self, log: SpanLog, name: str, requests: tuple, counts: dict):
        self.log, self.name, self.requests, self.counts = log, name, requests, counts

    def __enter__(self) -> "_Open":
        stack = self.log.stack()
        self.id = self.log.new_id()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        self._range.__exit__(*exc)
        self.log.stack().pop()
        self.log.add(Span(self.id, self.name, threading.get_ident(), self.start, end,
                          self.parent, self.requests, self.counts))


def span(name: str, *, requests: tuple = (), **counts):
    """``with span("engine.t2s"): ...``. Yields None when recording is off,
    else the open span, whose ``counts`` the block may add to.
    ``requests``: the ids of the requests the block serves."""
    log = _log
    if log is None:
        return _OFF
    return _Open(log, name, tuple(requests), counts)


def add_span(name: str, start: float, end: float, parent: int | None = None,
             requests: tuple = (), **counts) -> int | None:
    """Record ``[start, end]`` (``perf_counter`` seconds) as a span; its id,
    or None when recording is off."""
    log = _log
    if log is None:
        return None
    sid = log.new_id()
    log.add(Span(sid, name, threading.get_ident(), start, end, parent, tuple(requests), counts))
    return sid


@contextlib.contextmanager
def recording():
    """Record spans for the block: ``with recording() as log: ...``, then
    ``log.spans``. Inside another ``recording`` block it yields that
    block's log."""
    global _log
    if _log is not None:
        yield _log
        return
    log = _log = SpanLog()
    try:
        yield log
    finally:
        _log = None


def all_threads_config():
    """The profiler's setting that records the host operations of every
    thread, or None where the installed torch has none: there a profile
    holds the host operations of the thread that started it alone."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('exp/prof'): step(...)`` writes
    ``exp/prof/trace.json`` (open it in Perfetto or chrome://tracing), with
    the block's spans as named ranges."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), torch.profiler.profile(activities=activities,
                                             experimental_config=all_threads_config()) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)
