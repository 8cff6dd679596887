"""k-means: the nearest-centroid assignment and Lloyd's fit (port of
edm_tts_tpu/ops/kmeans.py ``_assign``, ``_kmeans_once`` and ``kmeans``).

``assign`` is the semantic tokenizer's last step: each HuBERT frame takes
the centroid at the least squared L2 distance, ``||x||^2 - 2 x.c +
||c||^2`` in f32 (the same three terms as the JAX package, so near-ties
break alike), with the product exact (no TF32: an argmin near a boundary is
sensitive to it).

``kmeans`` fits the semantic codebook (``hubert_kmeans``): best of
``nredo`` runs of ``niter`` Lloyd iterations (K 1024, niter 20, nredo 5,
seed 42 by default: faiss's settings in the reference), each from ``k``
distinct random frames, an empty cluster re-seeded with a random frame
after each update. As in the JAX package the distance product and the
one-hot cluster sums are plain f32 matrix products (``torch.matmul``, TF32
off). torch cannot draw ``jax.random.choice``'s picks, so the initial and
re-seed indices can be given (``init_indices`` ``(nredo, k)``,
``reseed_indices`` ``(nredo, niter, k)``), as the samplers take ``noise=``;
otherwise they come from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import numpy as np
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


def _kmeans_once(x: torch.Tensor, init_idx: torch.Tensor, reseed_idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd's run on f32 ``x`` ``(N, D)`` from the rows ``init_idx``
    ``(K,)``, re-seeding empty clusters with the rows ``reseed_idx[i]`` at
    iteration i. Returns ``(centers (K, D), inertia, inertia per
    iteration (niter,))``: the final inertia is that of the last centers,
    the per-iteration ones those of the centers each update started from."""
    k = init_idx.shape[0]
    centers = x[init_idx]
    history = []
    with exact_f32():
        for reseed in reseed_idx:
            labels, dists = assign(x, centers)
            history.append(dists.sum())
            one_hot = x.new_zeros(x.shape[0], k).scatter_(1, labels[:, None], 1.0)  # (N, K)
            counts = one_hot.sum(0)  # (K,)
            sums = one_hot.t() @ x  # (K, D)
            means = sums / counts.clamp(min=1.0)[:, None]
            centers = torch.where((counts > 0)[:, None], means, x[reseed])
        _, dists = assign(x, centers)
    return centers, dists.sum(), torch.stack(history) if history else x.new_zeros(0)


def kmeans(
    x,
    k: int,
    *,
    niter: int = 20,
    nredo: int = 5,
    seed: int = 42,
    init_indices=None,
    reseed_indices=None,
    history: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-of-``nredo`` Lloyd's k-means on ``x`` ``(N, D)`` (cast to f32,
    on its own device). Returns ``(centers (K, D), inertia)``.

    ``init_indices`` / ``reseed_indices``: the picks to use in place of the
    generator's (see the module docstring). ``history``: when a list is
    given, each run's per-iteration inertias are appended to it (a list of
    floats per run)."""
    x = torch.as_tensor(x).float()
    n = x.shape[0]
    if n < k:
        raise ValueError(f"kmeans: {n} points for {k} clusters")
    gen = torch.Generator(device=x.device).manual_seed(seed)
    best_centers, best_inertia = None, None
    for r in range(nredo):
        if init_indices is None:
            init = torch.randperm(n, generator=gen, device=x.device)[:k]
        else:
            init = torch.as_tensor(np.asarray(init_indices[r]), device=x.device).long()
        if reseed_indices is None:
            reseed = torch.randint(n, (niter, k), generator=gen, device=x.device)
        else:
            reseed = torch.as_tensor(np.asarray(reseed_indices[r]), device=x.device).long()
        centers, inertia, trace = _kmeans_once(x, init, reseed)
        if history is not None:
            history.append(trace.tolist())
        if best_centers is None or float(inertia) < float(best_inertia):
            best_centers, best_inertia = centers, inertia
    return best_centers, best_inertia
