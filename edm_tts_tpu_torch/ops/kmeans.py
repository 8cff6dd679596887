"""Nearest-centroid assignment (port of edm_tts_tpu/ops/kmeans.py ``_assign``).

The semantic tokenizer's last step: each HuBERT frame takes the centroid
at the least squared L2 distance, ``||x||^2 - 2 x.c + ||c||^2`` in f32 (the
same three terms as the JAX package, so near-ties break alike), with the
product exact (no TF32: an argmin near a boundary is sensitive to it).
The Lloyd's-iteration fit (``kmeans``, ``_kmeans_once``) is not ported.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.ops.precision import exact_f32


def sq_distances(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """f32 ``(..., K)`` squared distances of ``x`` ``(..., D)`` to ``centers`` ``(K, D)``."""
    x, centers = x.float(), centers.float()
    with exact_f32():
        cross = x @ centers.t()
    return (x * x).sum(-1, keepdim=True) - 2.0 * cross + (centers * centers).sum(-1)


def assign(x: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(labels, squared distance)`` of the nearest center of each row of
    ``x`` ``(..., D)``; ``centers`` ``(K, D)``."""
    d = sq_distances(x, centers)
    labels = d.argmin(-1)
    return labels, d.gather(-1, labels[..., None])[..., 0]
