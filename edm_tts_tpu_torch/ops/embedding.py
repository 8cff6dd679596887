"""Embedding lookup (forward of edm_tts_tpu/ops/embedding.py::embed_take).

The JAX version exists for its one-hot-matmul backward on the TPU; the
inference slice needs only the forward, a plain index.
"""

from __future__ import annotations

import torch


def embed_take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table``: ``(V, D)``; ``ids``: int ``(...,)`` -> ``(..., D)``."""
    return table[ids]
