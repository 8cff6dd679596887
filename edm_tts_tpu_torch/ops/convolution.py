"""Channel-last 1D convolutions and weight norm.

Port of edm_tts_tpu/ops/convolution.py. The public functions keep the JAX
layouts: activations ``(B, T, C)`` and kernels ``(K, C_in, C_out)``; they
transpose to torch's ``(B, C, T)`` / ``(C_out, C_in, K)`` inside. Length
arithmetic is torch's ``Conv1d`` / ``ConvTranspose1d`` (floor and
``output_padding``): the codec's odd stride 5 adds 2 samples.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` with the norm over every dim but the last.

    ``v``: ``(..., C_out)``; ``g``: ``(C_out,)``.
    """
    dims = tuple(range(v.dim() - 1))
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return v * (g / norm)


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """``x``: ``(B, T, C_in)``; ``kernel``: ``(K, C_in // groups, C_out)``.

    ``padding`` is symmetric, or an explicit ``(left, right)`` pair.
    """
    if isinstance(padding, int):
        padding = (padding, padding)
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(
        xt, kernel.permute(2, 1, 0), bias, stride=stride, dilation=dilation,
        groups=groups,
    )
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """Transposed conv; ``kernel[k, i, o]`` is torch's ``weight[i, o, k]``.

    Output length ``(T - 1) * stride - 2 * padding + K + output_padding``.
    """
    y = F.conv_transpose1d(
        x.transpose(1, 2), kernel.permute(1, 2, 0), bias, stride=stride,
        padding=padding, output_padding=output_padding,
    )
    return y.transpose(1, 2)


def conv1d_output_length(length, kernel_size: int, stride: int = 1, padding: int = 0,
                         dilation: int = 1):
    """torch ``Conv1d`` output length: ``floor((T + 2p - d(k-1) - 1) / s + 1)``.

    Works on ints and on integer arrays or tensors.
    """
    return (length + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def encoder_output_length(length, strides: Sequence[int]):
    """Frames the codec encoder's conv stack gives for ``length`` samples.

    The stem (k=7, pad 3), the residual units and the final k=3 conv keep
    the length; only each block's strided conv (k=2s, pad ceil(s/2))
    changes it.
    """
    out = length
    for s in strides:
        out = conv1d_output_length(out, 2 * s, stride=s, padding=math.ceil(s / 2))
    return out
