"""The codec ResidualUnit: kernel K1 (csrc/resunit.cu) and its plain version.

Port of edm_tts_tpu/ops/pallas_resunit.py (``fused_residual_unit``,
``_resunit_ref``): snake -> dilated k=7 conv -> snake -> k=1 conv -> + x.
Weights come weight-norm-folded in the JAX layout: ``w7`` ``(7, C, C)``
and ``w1`` ``(1, C, C)`` as ``[tap, in, out]``; alphas and biases ``(C,)``.
The kernel takes them as they are, laid out once when the model's weights
are loaded (``ResidualUnit.pack``): kernels contiguous bf16, alphas and
biases contiguous f32.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.kernels import launches, refuse_grad
from edm_tts_tpu_torch.kernels.build import check_launch, library
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


def fused_residual_unit(x, alpha1, w7, b7, alpha2, w1, b1, dilation: int):
    """Residual unit through K1 on the card, the plain version on the CPU.

    On CUDA: ``x`` contiguous bf16 ``(B, T, C)`` with ``C % 16 == 0``;
    ``w7`` and ``w1`` contiguous bf16, alphas and biases contiguous f32
    ``(C,)``, all on x's device. K1 has no backward: on CUDA it raises when
    autograd would need a gradient through it.
    """
    if not x.is_cuda:
        return resunit_reference(x, alpha1, w7, b7, alpha2, w1, b1, dilation=dilation)
    refuse_grad("fused_residual_unit", x, alpha1, w7, b7, alpha2, w1, b1)
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
    out = torch.empty_like(x)
    err = library().edm_resunit(
        x.data_ptr(), alpha1.data_ptr(), w7.data_ptr(), b7.data_ptr(),
        alpha2.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
        b, t, c, dilation, torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "fused_residual_unit")
    launches["resunit"] += 1
    return out
