"""The codec ResidualUnit: kernel K1 (csrc/resunit.cu) and its plain version.

Port of edm_tts_tpu/ops/pallas_resunit.py (``fused_residual_unit``,
``_resunit_ref``): snake -> dilated k=7 conv -> snake -> k=1 conv -> + x.
Weights come weight-norm-folded in the JAX layout: ``w7`` ``(7, C, C)``
and ``w1`` ``(1, C, C)`` as ``[tap, in, out]``; alphas and biases ``(C,)``.
The kernel takes them as they are, laid out once when the model's weights
are loaded (``ResidualUnit.pack``): kernels contiguous bf16, alphas and
biases contiguous f32.

On the card one unit is three launches of K1's source (one count in
``launches["resunit"]``): the snake of x, the dilated k=7 conv as an
implicit GEMM (bias and the second snake in its epilogue, into a bf16
scratch) and the k=1 conv (bias and residual in its epilogue), each product
in blocks of 128 time rows x ``resunit_tile`` output channels.

Under autograd K1 is the forward of an autograd function whose backward is
the VJP of ``resunit_reference`` on the saved inputs, as the JAX kernel's
``custom_vjp`` (edm_tts_tpu/ops/pallas_resunit.py, ``_bwd``): the gradient
reaches x, the alphas, the weights and the biases.
"""

from __future__ import annotations

import functools

import torch

from edm_tts_tpu_torch.kernels import (
    H100_SMS,
    launches,
    resunit_shapes,
    sm_count,
    with_plain_backward,
)
from edm_tts_tpu_torch.kernels.build import check_launch, library
from edm_tts_tpu_torch.ops.attention import _aligned
from edm_tts_tpu_torch.ops.convolution import conv1d
from edm_tts_tpu_torch.ops.snake import snake


def resunit_reference(x, alpha1, w7, b7, alpha2, w1, b1, *, dilation: int):
    """Plain composition: the CPU path and K1's oracle."""
    s = snake(x, alpha1)
    y = conv1d(s, w7.to(x.dtype), b7.to(x.dtype), padding=3 * dilation,
               dilation=dilation)
    s2 = snake(y, alpha2)
    y2 = s2 @ w1[0].to(x.dtype) + b1.to(x.dtype)
    return x + y2


# output channels per block of K1's two products (the wgmma N tile)
RESUNIT_TILES = (64, 128, 192, 256)
RESUNIT_ROWS = 128  # time rows per block
# the tile model's time per 64-channel step of a block and per block beyond
# its steps (filling the ring and the epilogue: hidden in part where two
# blocks share an SM), in one arbitrary unit, fitted to profile_resunit's
# sweep of every tile at run (a)'s and the served batch's units on an H100
# SXM (a step's products alone take 4 N clocks at the tensor cores' rate)
_STEP_COST = {64: 415, 128: 795, 192: 1085, 256: 1340}
_BLOCK_COST = {1: 32000, 2: 12000}


@functools.lru_cache(maxsize=None)
def resunit_tile(b: int, t: int, c: int, sms: int = H100_SMS) -> int:
    """K1's N tile for a ``(B, T, C)`` unit: the tile of ``RESUNIT_TILES``
    with the least modelled time. Blocks of up to 128 channels fit two on
    an SM, wider ones one; a wave is one block per slot; a block takes 8
    steps of 64 input channels per 64 channels of C (7 taps and the k=1
    conv) and a fixed cost. Narrow tiles lose to their copies and to the
    columns past C they compute, wide ones to the waves they leave idle
    and to a fixed cost no second block hides (one request's C=768 units
    take 192: 128 blocks in one wave)."""
    def cost(bn: int) -> tuple[int, int]:
        per_sm = 2 if bn <= 128 else 1
        blocks = -(-c // bn) * -(-t // RESUNIT_ROWS) * b
        waves = -(-blocks // (sms * per_sm))
        steps = 8 * -(-c // 64)
        return waves * per_sm * (steps * _STEP_COST[bn] + _BLOCK_COST[per_sm]), bn
    return min(RESUNIT_TILES, key=cost)


def fused_residual_unit(x, alpha1, w7, b7, alpha2, w1, b1, dilation: int, *,
                        tile: int | None = None):
    """Residual unit through K1 on the card, the plain version on the CPU.

    On CUDA: ``x`` contiguous bf16 ``(B, T, C)`` with ``C % 16 == 0``;
    ``w7`` and ``w1`` contiguous bf16, alphas and biases contiguous f32
    ``(C,)``, all on x's device. ``tile`` forces the N tile (one of
    ``RESUNIT_TILES``; else ``resunit_tile``'s choice); the CPU path ignores
    it. Differentiable: the backward is the plain version's VJP.
    """
    if not x.is_cuda:
        return resunit_reference(x, alpha1, w7, b7, alpha2, w1, b1, dilation=dilation)
    return with_plain_backward(
        functools.partial(_launch, dilation=dilation, tile=tile),
        functools.partial(resunit_reference, dilation=dilation),
        x, alpha1, w7, b7, alpha2, w1, b1)


def _launch(x, alpha1, w7, b7, alpha2, w1, b1, *, dilation: int, tile: int | None):
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_residual_unit: x must be contiguous bf16 (B, T, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, c = x.shape
    if c % 16 or w7.shape != (7, c, c) or w1.shape != (1, c, c):
        raise ValueError(f"fused_residual_unit: C={c} needs C % 16 == 0, w7 (7, C, C) "
                         f"and w1 (1, C, C); got {tuple(w7.shape)}, {tuple(w1.shape)}")
    for name, p, dtype in (("w7", w7, torch.bfloat16), ("w1", w1, torch.bfloat16),
                           ("alpha1", alpha1, torch.float32), ("b7", b7, torch.float32),
                           ("alpha2", alpha2, torch.float32), ("b1", b1, torch.float32)):
        if p.dtype != dtype or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"fused_residual_unit: {name} must be contiguous {dtype} "
                             f"on {x.device}, got {p.dtype} on {p.device}")
    if any(p.shape != (c,) for p in (alpha1, b7, alpha2, b1)):
        raise ValueError(f"fused_residual_unit: alphas and biases must be ({c},)")
    if w7.data_ptr() % 16 or w1.data_ptr() % 16:
        raise ValueError("fused_residual_unit: w7 and w1 must start on 16 bytes")
    if tile is None:
        tile = resunit_tile(b, t, c, sm_count(x.device.index or 0))
    elif tile not in RESUNIT_TILES:
        raise ValueError(f"fused_residual_unit: tile must be one of {RESUNIT_TILES} or "
                         f"None, got {tile}")
    x = _aligned(x)
    out, s2 = torch.empty_like(x), torch.empty_like(x)
    err = library().edm_resunit(
        x.data_ptr(), alpha1.data_ptr(), w7.data_ptr(), b7.data_ptr(),
        alpha2.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(), s2.data_ptr(),
        b, t, c, dilation, tile, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "fused_residual_unit")
    launches["resunit"] += 1
    resunit_shapes[(b, t, c, dilation)] += 1
    return out
