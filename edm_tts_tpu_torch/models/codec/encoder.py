"""Codec encoder (port of edm_tts_tpu/models/codec/encoder.py): 16 kHz
waveform -> 50 Hz latents.

k=7 stem, four EncoderBlocks (three residual units with dilations 1, 3, 9,
snake, strided conv with k = 2s and padding ceil(s/2)) doubling channels
while downsampling by (2, 4, 5, 8), then snake and a k=3 conv. Module
names follow the reference DAC's ``encoder.block.*`` keys; activations are
channel-last ``(B, T, C)``.

The residual units (C 64, 128, 256, 512 at the default width) run as
kernel K1 on the card, on the layouts ``pack`` made; the stem, the strided
convs and the final conv are ``F.conv1d``, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.layers import ResidualUnit, Snake, WNConv1d


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        half = dim // 2
        self.block = nn.ModuleList([
            ResidualUnit(half, 1, **kw),
            ResidualUnit(half, 3, **kw),
            ResidualUnit(half, 9, **kw),
            Snake(half, **kw),
            WNConv1d(half, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2), **kw),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = layer(x)
        return x


class Encoder(nn.Module):
    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 5, 8), *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = d_model
        layers: list[nn.Module] = [WNConv1d(1, d, 7, padding=3, **kw)]
        for stride in strides:
            d *= 2
            layers.append(EncoderBlock(d, stride, **kw))
        layers += [Snake(d, **kw), WNConv1d(d, d, 3, padding=1, **kw)]
        self.block = nn.ModuleList(layers)

    def pack(self) -> None:
        """Lay the residual units' weights out for K1 (after every load or move)."""
        for m in self.modules():
            if isinstance(m, ResidualUnit):
                m.pack()

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """``(B, T, 1)`` waveform -> ``(B, T / prod(strides), enc_dim)`` latents,
        in the module's dtype."""
        x = audio.to(self.block[0].bias.dtype)
        for layer in self.block:
            x = layer(x)
        return x
