"""The codec DecoderBlock tail: kernel K2 (csrc/decoder_block.cu) and its
plain version.

Port of edm_tts_tpu/ops/pallas_decoder_block.py (``fused_decoder_block``,
``_block_ref``, ``_phase_weights``): snake -> transposed conv (k = 2s,
stride s, padding s/2, even s) -> three residual units (dilations 1, 3, 9).

Both versions take the transposed conv in its phase form, laid out once
when the model's weights are loaded (``DecoderBlock.pack``): ``w3 =
phase_weights(kernel)`` ``(3, C_in, s*C_out)`` and the bias tiled ``s``
times. ``y[q] = sum_m snake(x)[q + m - 1] @ w3[m] + bias3`` is ``(T,
s*C_out)``, and read row-major it already is the interleaved ``(T*s,
C_out)`` output.

On the card K2 runs in two parts: its front (``tconv_phase``: a snake pass
and the phase product as an implicit GEMM on warpgroup MMA, in blocks of
128 frames x ``decoder_block_tile`` columns that skip the taps that are
zero for all their columns), then the three residual units as K1 launches
(ops/resunit.py). Each K1 launch zero-pads outside ``[0, T*s)``, which is
what the Pallas kernel's re-zeroing between stages does, so the two parts
compute the same block.

Under autograd the block (and the front alone) is the forward of an
autograd function whose backward is the VJP of its plain version on the
saved inputs, as the JAX kernel's ``custom_vjp``
(edm_tts_tpu/ops/pallas_decoder_block.py, ``_bwd``). The JAX kernel takes
the transposed-conv weight and differentiates it directly; here the
gradient reaches ``w3`` and ``bias3``, and through ``phase_weights`` and
the bias tiling (which the caller differentiates) the transposed conv.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from edm_tts_tpu_torch.kernels import H100_SMS, launches, sm_count, with_plain_backward
from edm_tts_tpu_torch.kernels.build import check_launch, library
from edm_tts_tpu_torch.ops.attention import _aligned
from edm_tts_tpu_torch.ops import resunit
from edm_tts_tpu_torch.ops.resunit import fused_residual_unit, resunit_reference
from edm_tts_tpu_torch.ops.snake import snake

DILATIONS = (1, 3, 9)


def phase_weights(kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """``(2s, C_in, C_out)`` transposed-conv kernel -> ``(3, C_in, s*C_out)``.

    ``out[s*q + r] = sum_m x[q + m - 1] @ w3[m][:, r]`` (the derivation in
    edm_tts_tpu/ops/convolution.py::conv_transpose1d_phases, p = s // 2).
    The phases ``r < s - p`` read taps 0 and 1, the others taps 1 and 2, so
    ``w3[2]`` is zero in the columns below ``p*C_out`` and ``w3[0]`` from
    there on (``phase_taps``).
    """
    k, cin, cout = kernel.shape
    s = stride
    if k != 2 * s or s % 2:
        raise ValueError(f"phase_weights: needs even s and k == 2s, got k={k}, s={s}")
    p = s // 2
    w3 = kernel.new_zeros((3, cin, s, cout))
    for r in range(s):
        if r < s - p:
            w3[0, :, r] = kernel[s + r + p]  # x[q-1]
            w3[1, :, r] = kernel[r + p]      # x[q]
        else:
            w3[1, :, r] = kernel[r + p]      # x[q]
            w3[2, :, r] = kernel[r + p - s]  # x[q+1]
    return w3.reshape(3, cin, s * cout)


def phase_taps(n0: int, n1: int, half: int) -> range:
    """The taps of ``w3`` that are nonzero somewhere in columns ``[n0, n1)``
    (``half = (s/2)*C_out``): 0 and 1 below ``half``, 1 and 2 from there
    on, all three across it. K2's blocks run exactly these."""
    return range(1 if n0 >= half else 0, 2 if n1 <= half else 3)


def tconv_phase_reference(x, alpha0, w3, bias3):
    """snake(x) -> the phase-form transposed conv, one plain product.

    ``x``: ``(B, T, C_in)``; ``w3``: ``(3, C_in, s*C_out)``; returns
    ``(B, T, s*C_out)``.
    """
    t = x.shape[1]
    y = F.pad(snake(x, alpha0), (0, 0, 1, 1))
    taps = torch.cat([y[:, m:m + t] for m in range(3)], dim=-1)
    return taps @ w3.reshape(-1, w3.shape[-1]).to(x.dtype) + bias3.to(x.dtype)


def decoder_block_reference(x, alpha0, w3, bias3, ru_params, *, stride: int):
    """Plain composition: the CPU path and K2's oracle.

    ``ru_params``: three tuples ``(alpha1, w7, b7, alpha2, w1, b1)`` for
    dilations 1, 3, 9.
    """
    b, t, _ = x.shape
    y = tconv_phase_reference(x, alpha0, w3, bias3).reshape(b, t * stride, -1)
    for d, p in zip(DILATIONS, ru_params):
        y = resunit_reference(y, *p, dilation=d)
    return y


# output columns per block of K2's phase product (the wgmma N tile)
DECODER_BLOCK_TILES = (64, 96, 128, 192, 256)
DECODER_BLOCK_ROWS = 128  # frames per block
# the tile model's time per 64-channel step of a block and per block beyond
# its steps: K1's fit (ops/resunit.py; the same GEMM), with the 96-column
# step between its 64 and 128. On an H100 SXM it picks the fastest tile of
# profile_decoder_block's sweep at run (a)'s two blocks (s4: 128, s2: 96)
_STEP_COST = {**resunit._STEP_COST, 96: 605}
_BLOCK_COST = resunit._BLOCK_COST


@functools.lru_cache(maxsize=None)
def decoder_block_tile(b: int, t: int, cin: int, n: int, stride: int,
                       sms: int = H100_SMS) -> int:
    """K2's column tile for the front of a ``(B, T, C_in)`` block with
    ``n = s*C_out`` product columns: the tile of ``DECODER_BLOCK_TILES``
    with the least modelled time. Blocks of up to 128 columns fit two on an
    SM, wider ones one; a wave is one block per slot; a block takes one
    step of 64 input channels per tap of ``phase_taps`` per 64 channels of
    C_in, and a fixed cost. A tile that straddles the halves runs three
    taps instead of two; narrow tiles lose to their copies, wide ones to
    the waves they leave idle."""
    half = stride // 2 * (n // stride)

    def cost(bn: int) -> tuple[float, int]:
        per_sm = 2 if bn <= 128 else 1
        col_tiles = -(-n // bn)
        taps = sum(len(phase_taps(j * bn, min(j * bn + bn, n), half)) for j in range(col_tiles))
        blocks = col_tiles * -(-t // DECODER_BLOCK_ROWS) * b
        waves = -(-blocks // (sms * per_sm))
        steps = taps / col_tiles * -(-cin // 64)
        return waves * per_sm * (steps * _STEP_COST[bn] + _BLOCK_COST[per_sm]), bn

    return min(DECODER_BLOCK_TILES, key=cost)


def tconv_phase(x, alpha0, w3, bias3, stride: int, *, tile: int | None = None):
    """K2's front, snake -> phase transposed conv, ``(B, T, C_in)`` ->
    ``(B, T*s, C_out)``: the kernel on the card, the plain version on the CPU.

    On CUDA: ``x`` contiguous bf16; ``w3`` contiguous bf16 ``(3, C_in,
    s*C_out)``; ``alpha0`` and ``bias3`` contiguous f32; ``C_in`` and
    ``C_out`` multiples of 16. ``tile`` forces the column tile (one of
    ``DECODER_BLOCK_TILES``; else ``decoder_block_tile``'s choice); the CPU
    path ignores it. Differentiable: the backward is the plain version's VJP.
    """
    def plain(x, alpha0, w3, bias3):
        b, t, _ = x.shape
        return tconv_phase_reference(x, alpha0, w3, bias3).reshape(b, t * stride, -1)

    if not x.is_cuda:
        return plain(x, alpha0, w3, bias3)
    return with_plain_backward(functools.partial(_launch_front, stride=stride, tile=tile),
                               plain, x, alpha0, w3, bias3)


def _launch_front(x, alpha0, w3, bias3, *, stride: int, tile: int | None):
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"fused_decoder_block: x must be contiguous bf16 (B, T, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, cin = x.shape
    n = w3.shape[-1]
    if (w3.shape != (3, cin, n) or stride < 2 or stride % 2 or n % stride or cin % 16
            or (n // stride) % 16):
        raise ValueError(f"fused_decoder_block: C_in={cin}, w3 {tuple(w3.shape)}, stride "
                         f"{stride} (need w3 (3, C_in, s*C_out), even s, channels % 16 == 0)")
    for name, p, dtype, shape in (("w3", w3, torch.bfloat16, (3, cin, n)),
                                  ("alpha0", alpha0, torch.float32, (cin,)),
                                  ("bias3", bias3, torch.float32, (n,))):
        if p.dtype != dtype or p.shape != shape or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"fused_decoder_block: {name} must be contiguous {dtype} "
                             f"{shape} on {x.device}")
    if w3.data_ptr() % 16:
        raise ValueError("fused_decoder_block: w3 must start on 16 bytes")
    if tile is None:
        tile = decoder_block_tile(b, t, cin, n, stride, sm_count(x.device.index or 0))
    elif tile not in DECODER_BLOCK_TILES:
        raise ValueError(f"fused_decoder_block: tile must be one of {DECODER_BLOCK_TILES} or "
                         f"None, got {tile}")
    x = _aligned(x)
    s1 = torch.empty_like(x)
    y = torch.empty((b, t * stride, n // stride), dtype=x.dtype, device=x.device)
    err = library().edm_tconv_phase(
        x.data_ptr(), alpha0.data_ptr(), w3.data_ptr(), bias3.data_ptr(), s1.data_ptr(),
        y.data_ptr(), b, t, cin, n, stride, tile,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "fused_decoder_block")
    launches["decoder_block"] += 1
    return y


def fused_decoder_block(x, alpha0, w3, bias3, ru_params, stride: int):
    """Decoder block through K2 (+ K1) on the card, the plain version on CPU.

    On CUDA: the front's arguments as ``tconv_phase`` takes them, the
    residual units' parameters as ``fused_residual_unit`` takes them.
    Differentiable: the backward is the VJP of ``decoder_block_reference``.
    """
    if not x.is_cuda:
        return decoder_block_reference(x, alpha0, w3, bias3, ru_params, stride=stride)
    flat = [p for u in ru_params for p in u]

    def units(flat_params):
        return [tuple(flat_params[i:i + 6]) for i in range(0, len(flat_params), 6)]

    def launch(x, alpha0, w3, bias3, *flat_params):
        y = tconv_phase(x, alpha0, w3, bias3, stride)
        for d, p in zip(DILATIONS, units(flat_params)):
            y = fused_residual_unit(y, *p, d)
        return y

    def plain(x, alpha0, w3, bias3, *flat_params):
        return decoder_block_reference(x, alpha0, w3, bias3, units(flat_params), stride=stride)

    return with_plain_backward(launch, plain, x, alpha0, w3, bias3, *flat)
