"""Train-state checkpoints (port of edm_tts_tpu/parallel/checkpoint.py).

``torch.save`` of the model, the optimizer and the step instead of orbax,
with the JAX package's layout and rules: ``<output_dir>/checkpoint_<step>``
directories (here ``state.pt`` and ``metadata.json``), the newest
``save_total_limit`` kept, and ``detect_last_checkpoint``'s guard against
writing into a non-empty directory that holds no checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import torch

CHECKPOINT_PREFIX = "checkpoint_"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := re.fullmatch(CHECKPOINT_PREFIX + r"(\d+)", name)))


class CheckpointManager:
    """Step-indexed train-state checkpoints with metadata and retention."""

    def __init__(self, directory: str, save_total_limit: int | None = 2):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{CHECKPOINT_PREFIX}{step}")

    def save(self, step: int, state: Any, metadata: dict | None = None) -> str | None:
        """Write ``state`` (tensors are saved from wherever they live) as
        ``checkpoint_<step>``; a step already saved is left as it is and
        None returned. Written under a temporary name and renamed, so a run
        killed mid-save leaves no half checkpoint."""
        final = self.path(step)
        if os.path.exists(final):
            return None
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(metadata or {}, f)
        os.replace(tmp, final)
        if self.save_total_limit is not None:
            for old in _steps(self.directory)[:-self.save_total_limit]:
                shutil.rmtree(self.path(old))
        return final

    def restore(self, step: int | None = None, map_location=None) -> tuple[Any, dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self.path(step)
        state = torch.load(os.path.join(path, "state.pt"), map_location=map_location,
                           weights_only=True)
        with open(os.path.join(path, "metadata.json")) as f:
            return state, json.load(f)

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None


def detect_last_checkpoint(output_dir: str, overwrite_output_dir: bool = False) -> int | None:
    """The latest checkpoint step in ``output_dir``, or None.

    Raises ValueError if the directory is not empty but holds no checkpoint
    (so a previous run's files are not overwritten by accident), unless
    ``overwrite_output_dir`` is set."""
    if overwrite_output_dir or not os.path.isdir(output_dir):
        return None
    steps = _steps(output_dir)
    if steps:
        return steps[-1]
    if os.listdir(output_dir):
        raise ValueError(f"Output directory ({output_dir}) already exists and is not empty. "
                         "Set overwrite_output_dir=True to overcome.")
    return None
