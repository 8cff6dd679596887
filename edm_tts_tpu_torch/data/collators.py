"""Batch collators (copy of ``collate_s2a`` in edm_tts_tpu/data/collators.py,
whose module imports the t2s config and with it jax; pinned equal by
tests/test_torch_train_data.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def collate_s2a(examples: Sequence[dict]) -> dict:
    """Stack aligned code crops -> {acoustic_tokens (B,Q,T), semantic_tokens (B,T)}."""
    return {
        "acoustic_tokens": np.stack(
            [e["acoustic_tokens"] for e in examples]
        ).astype(np.int32),
        "semantic_tokens": np.stack(
            [e["semantic_tokens"] for e in examples]
        ).astype(np.int32),
    }
