"""Codec decoder (port of edm_tts_tpu/models/codec/decoder.py).

k=7 stem (latent 1024 -> 1536), four DecoderBlocks halving channels while
upsampling by (8, 5, 4, 2) — snake, transposed conv (k = 2s, padding s//2,
output_padding s%2: an odd stride adds 2 samples) and residual units with
dilations 1, 3, 9 — then snake, k=7 conv to 1 channel and tanh. Module
names follow the reference DAC's ``decoder.model.*`` keys.

On the card the residual units run as kernel K1 and the s=4 and s=2 tail
blocks as kernel K2, as the JAX package selects its Pallas kernels (even
stride dividing 40, C_out <= 192). The ``valid_frames`` masked decode of a
padded canvas is not ported yet: the synthesis path decodes the whole
canvas.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.layers import (
    ResidualUnit,
    Snake,
    WNConv1d,
    WNConvTranspose1d,
)
from edm_tts_tpu_torch.ops import fused_decoder_block
from edm_tts_tpu_torch.ops.decoder_block import phase_weights

_FUSED_HALO = 40  # the JAX kernel's halo; its strides must divide it


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stride = stride
        self.block = nn.ModuleList([
            Snake(cin, **kw),
            WNConvTranspose1d(cin, cout, 2 * stride, stride=stride, padding=stride // 2,
                              output_padding=stride % 2, **kw),
            ResidualUnit(cout, 1, **kw),
            ResidualUnit(cout, 3, **kw),
            ResidualUnit(cout, 9, **kw),
        ])
        self.fused = stride % 2 == 0 and _FUSED_HALO % stride == 0 and cout <= 192
        self.kernel_args: tuple[torch.Tensor, ...] | None = None

    @torch.no_grad()
    def pack(self) -> None:
        """Pack the residual units and, for a fused block, lay the snake and
        transposed conv out as K2 takes them: alpha in f32, the phase weights
        ``(3, C_in, s*C_out)`` in the module's dtype, the bias tiled ``s``
        times in f32."""
        snake0, tconv, *units = self.block
        for u in units:
            u.pack()
        if self.fused:
            wt, bt = tconv.folded()
            self.kernel_args = (
                snake0.alpha.detach().view(-1).float().contiguous(),
                phase_weights(wt.detach(), self.stride).contiguous(),
                bt.detach().float().repeat(self.stride).contiguous(),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        snake0, tconv, *units = self.block
        if self.fused:
            if self.kernel_args is None:
                raise RuntimeError("DecoderBlock: weights not packed; load them through "
                                   "edm_tts_tpu_torch.convert or call pack()")
            return fused_decoder_block(x.contiguous(), *self.kernel_args,
                                       [u.kernel_args for u in units], self.stride)
        x = tconv(snake0(x))
        for u in units:
            x = u(x)
        return x


class Decoder(nn.Module):
    def __init__(self, latent_dim: int = 1024, channels: int = 1536,
                 rates: Sequence[int] = (8, 5, 4, 2), d_out: int = 1, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        layers: list[nn.Module] = [WNConv1d(latent_dim, channels, 7, padding=3, **kw)]
        for i, stride in enumerate(rates):
            layers.append(DecoderBlock(channels // 2**i, channels // 2 ** (i + 1), stride, **kw))
        out_dim = channels // 2 ** len(rates)
        layers += [Snake(out_dim, **kw), WNConv1d(out_dim, d_out, 7, padding=3, **kw)]
        self.model = nn.ModuleList(layers)

    def pack(self) -> None:
        """Lay the blocks' weights out for the kernels (after every load)."""
        for layer in self.model:
            if isinstance(layer, DecoderBlock):
                layer.pack()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``(B, T50, latent_dim)`` -> ``(B, T_audio, d_out)``."""
        x = z
        for layer in self.model:
            x = layer(x)
        return torch.tanh(x)
