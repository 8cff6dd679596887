"""Preemption-safe training: checkpoint on SIGTERM (copy of
edm_tts_tpu/train/preemption.py; pinned equal by
tests/test_torch_train_data.py).

Schedulers deliver SIGTERM with a grace window before eviction. The
trainer wraps its step loop in a :class:`PreemptionGuard` and cuts a final
checkpoint the moment a signal lands, so a preempted run resumes from the
exact step it was stopped at (auto-resume picks up the latest checkpoint).

The handler only sets a flag: the loop finishes the step in flight and
saves from well-defined state; no checkpoint is written from inside a
signal handler. Handlers can only be installed in the main thread;
elsewhere the guard is a flag that ``trigger()`` can still set.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Context manager: latch SIGTERM (configurable) into a poll-able flag.

    Usage::

        with PreemptionGuard() as guard:
            for step in range(...):
                train_step(...)
                if guard.triggered:
                    save(step); break
    """

    def __init__(self, signals: tuple = (signal.SIGTERM,)):
        self._signals = signals
        self._flag = threading.Event()
        self._prev: dict = {}

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:
            # not the main thread: signals cannot be installed; the guard
            # still works via trigger()
            logger.debug("PreemptionGuard inactive (not main thread)")
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        logger.warning("signal %s received: checkpointing at next step", signum)
        self._flag.set()

    def trigger(self) -> None:
        """Programmatic preemption (tests, external watchdogs)."""
        self._flag.set()

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()
