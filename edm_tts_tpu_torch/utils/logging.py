"""Metric logging (port of edm_tts_tpu/utils/logging.py without TensorBoard):
a ``metrics.jsonl`` stream in the output directory, which survives
preemption, Python logging, and remote experiment trackers.

A tracker (wandb, mlflow, ...) plugs in through the ``Tracker`` interface:
pass instances to ``MetricLogger(trackers=...)`` or name factories in the
training YAML (``trackers: ["my_pkg.trk:make"]``, the reference's
``report_to``), and every scalar dict and eval audio sample is fanned out to
them. ``Tracker``, ``tracker_from_spec`` and the fan-out are copies of the
JAX package's, pinned equal by tests/test_torch_f32_train.py.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import sys
import time
from typing import Mapping, Protocol, Sequence, runtime_checkable

logger = logging.getLogger("edm_tts_tpu_torch")


@runtime_checkable
class Tracker(Protocol):
    """Remote experiment tracker interface (wandb-analog plug point)."""

    def log_scalars(self, step: int, scalars: Mapping[str, float]) -> None: ...

    def log_audio(
        self, step: int, name: str, waveform, sample_rate: int
    ) -> None: ...

    def close(self) -> None: ...


def tracker_from_spec(spec: str) -> Tracker:
    """Instantiate a tracker from a ``"module.path:factory"`` string.

    The factory is called with no arguments and must return a ``Tracker``.
    This is how YAML configs name remote trackers without this package
    importing them unconditionally."""
    module, _, factory = spec.partition(":")
    fn = getattr(importlib.import_module(module), factory or "make_tracker")
    return fn()


def setup_logging(level=logging.INFO) -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        handlers=[logging.StreamHandler(sys.stdout)],
        level=level,
    )
    return logger


class MetricLogger:
    def __init__(self, output_dir: str, trackers: Sequence[Tracker | str] = ()):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self.trackers = [
            tracker_from_spec(t) if isinstance(t, str) else t for t in trackers
        ]

    def add_tracker(self, tracker: Tracker) -> None:
        self.trackers.append(tracker)

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = "") -> dict:
        """Append one record and fan its scalars out to the trackers;
        returns it (floats, keys with ``prefix``)."""
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        scalars = {k: v for k, v in record.items() if k not in ("step", "time")}
        for t in self.trackers:
            self._safe(t, "log_scalars", step, scalars)
        return record

    def log_audio(self, step: int, name: str, waveform, sample_rate: int) -> None:
        """Fan an eval audio sample out to remote trackers (wandb.Audio
        analog). The on-disk wav export is the trainer's job; this hook is
        only the remote-tracking path."""
        for t in self.trackers:
            self._safe(t, "log_audio", step, name, waveform, sample_rate)

    def _safe(self, tracker, method, *args):
        """Remote trackers must never kill a training run: the durable sinks
        (jsonl/TB) are already written when these fire."""
        try:
            getattr(tracker, method)(*args)
        except Exception:  # pragma: no cover - tracker-dependent
            logger.warning(
                "tracker %r failed in %s (ignored)", tracker, method,
                exc_info=True,
            )

    def close(self) -> None:
        self._jsonl.close()
        for t in self.trackers:
            self._safe(t, "close")
