"""Embedding lookup and the masked cross-entropy (port of
edm_tts_tpu/ops/embedding.py).

The JAX ``embed_take`` has a one-hot-matmul backward because XLA:TPU
serialises the scatter-add of a gather's gradient; here ``table[ids]`` and
its index-add backward give the same gradient (pinned by a test).
"""

from __future__ import annotations

import torch


def embed_take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table``: ``(V, D)``; ``ids``: int ``(...,)`` -> ``(..., D)``."""
    return table[ids]


def masked_nll(
    logits: torch.Tensor, labels: torch.Tensor, loss_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-entropy summed over the ``loss_mask`` positions, and their
    count (f32 scalars; the two halves of the mean, for a mean whose batch
    is split over ranks)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    m = loss_mask.float()
    return (nll * m).sum(), m.sum()


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, loss_mask: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over the ``loss_mask`` positions.

    ``logits`` ``(..., V)`` (statistics in f32), ``labels`` int ``(...,)``
    in range, ``loss_mask`` bool ``(...,)``: f32 logsumexp minus the picked
    logit, summed over the mask and divided by ``max(count, 1)``.
    """
    total, count = masked_nll(logits, labels, loss_mask)
    return total / count.clamp_min(1.0)
