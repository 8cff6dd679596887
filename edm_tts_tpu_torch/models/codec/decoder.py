"""Codec decoder (port of edm_tts_tpu/models/codec/decoder.py).

k=7 stem (latent 1024 -> 1536), four DecoderBlocks halving channels while
upsampling by (8, 5, 4, 2) — snake, transposed conv (k = 2s, padding s//2,
output_padding s%2: an odd stride adds 2 samples) and residual units with
dilations 1, 3, 9 — then snake, k=7 conv to 1 channel and tanh. Module
names follow the reference DAC's ``decoder.model.*`` keys.

On the card the residual units run as kernel K1 and the s=4 and s=2 tail
blocks as kernel K2, as the JAX package's "auto" rule selects its Pallas
kernels: K2 for bf16 activations at an even stride dividing 40 and C_out
<= 192 (``DecoderBlock.uses_kernel``), K1 for bf16 units
(``layers.resunit_uses_kernel``); in f32 every block and unit runs the
plain composition.

``valid_frames`` decodes a padded canvas so that each row's valid samples
equal the decode of its exact-size canvas: invalid rows are zeroed after
the stem, after each transposed conv and after each residual unit, which
reproduces the zero padding an exact canvas's convs see. K2 does not
re-zero between its stages, so a block with a boundary runs unfused; the
residual units stay K1 (they ignore the boundary, as in the JAX package).

Under autograd K1 and K2 take the live weights, and their backward is the
plain composition's, as the JAX kernels' ``custom_vjp`` is.
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
    records_grad,
)
from edm_tts_tpu_torch.ops import fused_decoder_block
from edm_tts_tpu_torch.ops.decoder_block import phase_weights

_FUSED_HALO = 40  # the JAX kernel's halo; its strides must divide it


def _zero_invalid(x: torch.Tensor, boundary: torch.Tensor | None) -> torch.Tensor:
    """Zero time rows ``>= boundary[b]`` of ``(B, T, C)``."""
    if boundary is None:
        return x
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < boundary[:, None]
    return torch.where(keep[..., None], x, 0)


def _grow(boundary: torch.Tensor | None, stride: int) -> torch.Tensor | None:
    """The boundary after a transposed conv: ``s*v``, +2 for an odd stride
    (the kernel overhang an exact canvas keeps)."""
    if boundary is None:
        return None
    return stride * boundary + (2 if stride % 2 else 0)


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

    def _front_layout(self, dtype) -> tuple[torch.Tensor, ...]:
        snake0, tconv = self.block[:2]
        wt, bt = tconv.folded()
        return (snake0.alpha.view(-1).float().contiguous(),
                phase_weights(wt.to(dtype), self.stride).contiguous(),
                bt.float().repeat(self.stride).contiguous())

    @torch.no_grad()
    def pack(self) -> None:
        """Pack the residual units and, for a fused block, lay the snake and
        transposed conv out as K2 takes them: alpha in f32, the phase weights
        ``(3, C_in, s*C_out)`` in the module's dtype, the bias tiled ``s``
        times in f32."""
        for u in self.block[2:]:
            u.pack()
        if self.fused:
            self.kernel_args = self._front_layout(self.block[1].bias.dtype)

    def kernel_inputs(self, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        """K2's front arguments: the packed ones, or, while autograd records
        through the block, its live weights in the same layouts (the
        gradient reaches the transposed conv through ``phase_weights``)."""
        if records_grad(self):
            return self._front_layout(dtype)
        return self.kernel_args

    def uses_kernel(self, x: torch.Tensor, boundary: torch.Tensor | None) -> bool:
        """Whether this block runs K2 on ``x``: a block the kernel takes
        (``fused``), bf16 activations and no boundary to re-impose."""
        return self.fused and x.dtype == torch.bfloat16 and boundary is None

    def forward(self, x: torch.Tensor, boundary: torch.Tensor | None = None) -> torch.Tensor:
        snake0, tconv, *units = self.block
        if self.uses_kernel(x, boundary):
            if self.kernel_args is None:
                raise RuntimeError("DecoderBlock: weights not packed; load them through "
                                   "edm_tts_tpu_torch.convert or call pack()")
            return fused_decoder_block(x.contiguous(), *self.kernel_inputs(x.dtype),
                                       [u.kernel_inputs(x.dtype) for u in units], self.stride)
        boundary = _grow(boundary, self.stride)
        x = _zero_invalid(tconv(snake0(x)), boundary)  # snake(0) == 0
        for u in units:
            # the k=7 conv bias leaks into the invalid rows: re-zero them
            x = _zero_invalid(u(x), boundary)
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

    def forward(self, z: torch.Tensor, valid_frames: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, T50, latent_dim)`` -> ``(B, T_audio, d_out)``.

        ``valid_frames`` (optional int ``(B,)``): the masked decode of a
        padded canvas; samples past ``valid_frames * hop`` are garbage.
        """
        stem, *blocks, snake, final = self.model
        boundary = valid_frames
        x = _zero_invalid(stem(_zero_invalid(z, boundary)), boundary)
        for block in blocks:
            x = block(x, boundary)
            boundary = _grow(boundary, block.stride)
        return torch.tanh(final(snake(x)))
