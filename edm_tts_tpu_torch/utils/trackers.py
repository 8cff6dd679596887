"""A tracker that keeps what it is given, in memory.

``trackers: ["edm_tts_tpu_torch.utils.trackers:make_tracker"]`` in a
training recipe attaches one to the trainer's ``MetricLogger``; the caller
reads it back from ``trainer.metrics.trackers`` after the run. It shows that
every logged scalar (``watch`` norms included) reaches a remote tracker,
without a tracking service.
"""

from __future__ import annotations

from typing import Mapping


class MemoryTracker:
    """``utils.logging.Tracker`` that records its calls."""

    def __init__(self):
        self.scalars: list[tuple[int, dict[str, float]]] = []
        self.audio: list[tuple[int, str, int]] = []
        self.closed = False

    def log_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        self.scalars.append((step, dict(scalars)))

    def log_audio(self, step: int, name: str, waveform, sample_rate: int) -> None:
        self.audio.append((step, name, sample_rate))

    def close(self) -> None:
        self.closed = True


def make_tracker() -> MemoryTracker:
    return MemoryTracker()
