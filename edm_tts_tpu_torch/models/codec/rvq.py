"""Residual VQ (port of edm_tts_tpu/models/codec/rvq.py).

``quantizers.{i}`` mirror the reference's per-level modules: a 1x1
``in_proj`` (weight norm over the In axis), an ``N x dc`` codebook and a
1x1 ``out_proj``. ``forward`` quantizes (each level in-projects the
residual, takes the nearest L2-normalized codebook vector and subtracts its
out-projection) with the training semantics of the JAX package:

- the straight-through estimator ``z_e + sg(z_q - z_e)``;
- the commitment and codebook MSEs in codebook space, per sample, then a
  batch mean of the dropout-masked per-sample values, summed over levels;
- the residual is reduced by the *unmasked* out-projection, while the
  output sum is masked;
- quantizer dropout (``active_level_thresholds``): the first
  ``floor(B * p)`` samples get a drawn active level count in [1, Q],
  everyone else ``(n_quantizers or Q) + 1``, the reference's off-by-one
  (+1) kept as the JAX package keeps it. torch cannot replay
  ``jax.random``: the draw takes a ``torch.Generator``, or the thresholds
  come in drawn elsewhere (``thresholds=``).

Decode: ``embed_codes``, ``from_codes``, ``from_codes_unreduced``,
``get_projected_codebook``; encode: ``forward``, ``from_latents``,
``continuous_to_codes``, ``continuous_to_quantized_features``,
``latents_to_codebook_dist``. The VQ math stays f32 whatever dtype the
rest of the model runs in: its parameters are always created in f32, and
the products run without TF32.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.layers import WNConv1d
from edm_tts_tpu_torch.ops.kmeans import sq_distances
from edm_tts_tpu_torch.ops.precision import exact_f32


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize`` over the last axis: ``x / max(||x||, eps)``."""
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=eps)


def _nearest(e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest L2-normalized codebook row to each normalized
    ``e`` row (``||e||^2 - 2 e.c + ||c||^2``, as the JAX package)."""
    return sq_distances(_l2n(e), _l2n(codebook)).argmin(-1)


class VectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1, **kw)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1, **kw)
        self.codebook = nn.Embedding(codebook_size, codebook_dim, **kw)

    def project_in(self, x: torch.Tensor) -> torch.Tensor:
        """``(..., D)`` -> ``(..., dc)``."""
        return x @ self.in_proj.weight[:, :, 0].t() + self.in_proj.bias

    def project_out(self, z: torch.Tensor) -> torch.Tensor:
        """``(..., dc)`` -> ``(..., D)``."""
        return z @ self.out_proj.weight[:, :, 0].t() + self.out_proj.bias


class ResidualVQ(nn.Module):
    def __init__(self, input_dim: int = 1024, n_codebooks: int = 12,
                 codebook_size: int = 1024, codebook_dim: int = 8,
                 quantizer_dropout: float = 0.0, *, device=None):
        super().__init__()
        self.codebook_dim = codebook_dim
        self.quantizer_dropout = quantizer_dropout
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, codebook_dim, device=device)
            for _ in range(n_codebooks)
        )

    def _out_proj(self, nq: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked ``(Q', dc, D)`` out-projection kernels and ``(Q', D)`` biases."""
        levels = self.quantizers[:nq]
        w = torch.stack([q.out_proj.weight[:, :, 0].t() for q in levels])
        b = torch.stack([q.out_proj.bias for q in levels])
        return w, b

    def active_level_thresholds(self, batch_size: int, n_quantizers: int | None = None,
                                train: bool = False, generator: torch.Generator | None = None,
                                device=None) -> torch.Tensor:
        """Per-sample f32 threshold ``(B,)``; level q takes part iff ``q < thr``."""
        q = len(self.quantizers)
        thr = torch.full((batch_size,), float((n_quantizers or q) + 1), device=device)
        if train and self.quantizer_dropout > 0.0:
            if generator is None:
                raise ValueError("quantizer dropout needs a generator (or thresholds=)")
            draws = torch.randint(1, q + 1, (batch_size,), generator=generator,
                                  device=generator.device)
            n_dropout = int(batch_size * self.quantizer_dropout)
            thr[:n_dropout] = draws[:n_dropout].to(thr)
        return thr

    def forward(self, z: torch.Tensor, n_quantizers: int | None = None, *, train: bool = False,
                generator: torch.Generator | None = None,
                thresholds: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """Quantize ``(B, T, D)`` latents through every level.

        Returns ``z`` (B, T, D) f32, the out-projections summed over the
        levels below each sample's threshold; ``codes`` (B, Q, T) int64 of
        every level; ``latents`` (B, T, Q, dc), each level's in-projection
        before quantization; ``vq/commitment_loss`` and
        ``vq/codebook_loss``. ``train`` with dropout > 0 draws thresholds
        from ``generator``; ``thresholds`` (B,) replaces the draw.
        """
        residual = z.float()
        if thresholds is None:
            thresholds = self.active_level_thresholds(z.shape[0], n_quantizers, train,
                                                      generator, z.device)
        z_q = torch.zeros_like(residual)
        commit = cb_loss = torch.zeros((), device=z.device)
        codes, latents = [], []
        with torch.autocast(residual.device.type, enabled=False), exact_f32():
            for i, q in enumerate(self.quantizers):
                mask = (i < thresholds).float()  # (B,)
                z_e = q.project_in(residual)
                cb = q.codebook.weight
                idx = _nearest(z_e.detach(), cb.detach())
                z_c = cb[idx]
                commit = commit + (mask * (z_e - z_c.detach()).square().mean((1, 2))).mean()
                cb_loss = cb_loss + (mask * (z_c - z_e.detach()).square().mean((1, 2))).mean()
                out = q.project_out(z_e + (z_c - z_e).detach())  # straight-through
                z_q = z_q + out * mask[:, None, None]
                residual = residual - out
                codes.append(idx)
                latents.append(z_e)
        return {"z": z_q, "codes": torch.stack(codes, dim=1),
                "latents": torch.stack(latents, dim=2),
                "vq/commitment_loss": commit, "vq/codebook_loss": cb_loss}

    def latents_to_codebook_dist(self, latents: torch.Tensor) -> torch.Tensor:
        """``(B, T, D)`` features -> residual-VQ squared distances ``(B, T, Q, N)``:
        at each level the residual is in-projected, matched normalized, and
        reduced by the out-projection of its nearest vector."""
        residual = latents.float()
        dists = []
        with torch.autocast(residual.device.type, enabled=False), exact_f32():
            for q in self.quantizers:
                cb = q.codebook.weight
                dist = sq_distances(_l2n(q.project_in(residual)), _l2n(cb))
                residual = residual - q.project_out(cb[dist.argmin(-1)])
                dists.append(dist)
        return torch.stack(dists, dim=2)

    def continuous_to_quantized_features(self, latents: torch.Tensor) -> torch.Tensor:
        """``(B, T, D)`` features -> summed quantized features (a full VQ pass)."""
        return self(latents)["z"]

    def get_projected_codebook(self, codebook_idx: int) -> torch.Tensor:
        """Out-projected codebook table ``(N, D)`` of one level."""
        q = self.quantizers[codebook_idx]
        with torch.autocast(q.codebook.weight.device.type, enabled=False), exact_f32():
            return q.project_out(q.codebook.weight)

    def continuous_to_codes(self, latents: torch.Tensor) -> torch.Tensor:
        """``(B, T, D)`` features -> ``(B, Q, T)`` codes (a full VQ pass)."""
        return self(latents)["codes"]

    def from_latents(self, latents: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``(B, T, Q' * dc)`` projected latents -> ``(z_q, z_p, codes)``.

        Each level's slice is matched, L2-normalized, against its codebook
        (no in-projection: the latents are in codebook space already);
        ``z_q`` (B, T, D), ``z_p`` (B, T, Q', dc), ``codes`` (B, Q', T).
        """
        nq = latents.shape[-1] // self.codebook_dim
        parts = latents.float().reshape(*latents.shape[:-1], nq, self.codebook_dim)
        with torch.autocast(parts.device.type, enabled=False), exact_f32():
            codes = torch.stack([_nearest(parts[..., i, :], q.codebook.weight)
                                 for i, q in enumerate(self.quantizers[:nq])], dim=-1)
            z_p = self.embed_codes(codes.transpose(1, 2)).transpose(1, 2)  # (B, T, Q', dc)
            w, b = self._out_proj(nq)
            z_q = torch.einsum("btqc,qcd->btd", z_p, w) + b.sum(0)
        return z_q, z_p, codes.transpose(1, 2)

    def embed_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` codes -> raw codebook vectors ``(B, Q', T, dc)``."""
        return torch.stack(
            [q.codebook.weight[codes[:, i]] for i, q in enumerate(self.quantizers[: codes.shape[1]])],
            dim=1,
        )

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` codes -> summed quantized features ``(B, T, D)``."""
        w, b = self._out_proj(codes.shape[1])
        return torch.einsum("bqtc,qcd->btd", self.embed_codes(codes), w) + b.sum(0)

    def from_codes_unreduced(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` codes -> per-level features ``(B, Q', T, D)``."""
        w, b = self._out_proj(codes.shape[1])
        return torch.einsum("bqtc,qcd->bqtd", self.embed_codes(codes), w) + b[None, :, None, :]
