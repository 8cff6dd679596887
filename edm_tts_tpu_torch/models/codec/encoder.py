"""Codec encoder (port of edm_tts_tpu/models/codec/encoder.py).

k=7 stem, four EncoderBlocks (three residual units, snake, strided conv
with k = 2s and padding ceil(s/2)) doubling channels while downsampling by
(2, 4, 5, 8), then snake and a k=3 conv. Module names follow the
reference DAC's ``encoder.block.*`` keys. Only the parameters are here, so
that a full codec checkpoint loads strictly; the synthesis path does not
run the encoder, and its forward comes with the prompt-tokenization slice.
"""

from __future__ import annotations

import math
from typing import Sequence

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
