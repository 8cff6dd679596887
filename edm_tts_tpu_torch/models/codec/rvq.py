"""Residual VQ decode side (port of edm_tts_tpu/models/codec/rvq.py).

``quantizers.{i}`` mirror the reference's per-level modules: a 1x1
``in_proj`` (folded weight norm over the In axis), an ``N x dc`` codebook
and a 1x1 ``out_proj``. The slice needs codes -> features only
(``embed_codes``, ``from_codes``, ``from_codes_unreduced``). The VQ math
stays f32 whatever dtype the rest of the model runs in: its parameters are
always created in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.layers import WNConv1d


class VectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1, **kw)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1, **kw)
        self.codebook = nn.Embedding(codebook_size, codebook_dim, **kw)


class ResidualVQ(nn.Module):
    def __init__(self, input_dim: int = 1024, n_codebooks: int = 12,
                 codebook_size: int = 1024, codebook_dim: int = 8, *, device=None):
        super().__init__()
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
