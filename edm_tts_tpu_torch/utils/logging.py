"""Metric logging (``MetricLogger`` and ``setup_logging`` of
edm_tts_tpu/utils/logging.py without the remote trackers and TensorBoard):
a ``metrics.jsonl`` stream in the output directory, which survives
preemption, plus Python logging.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Mapping

logger = logging.getLogger("edm_tts_tpu_torch")


def setup_logging(level=logging.INFO) -> logging.Logger:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        handlers=[logging.StreamHandler(sys.stdout)],
        level=level,
    )
    return logger


class MetricLogger:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = "") -> dict:
        """Append one record; returns it (floats, keys with ``prefix``)."""
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        return record

    def close(self) -> None:
        self._jsonl.close()
