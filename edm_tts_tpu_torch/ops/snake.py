"""Snake activation ``x + sin^2(alpha x) / alpha`` on channel-last input.

Port of edm_tts_tpu/ops/snake.py: ``sin^2(u) = (1 - cos(2u)) / 2`` with the
same Cody-Waite reduction and degree-12 even polynomial for ``cos``. The
CUDA kernels evaluate the same polynomial as a device function
(csrc/common.cuh), so the plain version and the kernels agree.
"""

from __future__ import annotations

import torch

_INV_2PI = 0.15915494309189535
_PI2_HI = 6.28125
_PI2_LO = 1.9353071795864792e-03
_COS_C = (
    1.0,
    -4.9999997057e-01,
    4.1666583047e-02,
    -1.3888208529e-03,
    2.4777785560e-05,
    -2.7150122876e-07,
    1.7484986519e-09,
)


def cos_fast(u: torch.Tensor) -> torch.Tensor:
    """cos(u) for f32 ``u``: range-reduce to [-pi, pi], then the even poly."""
    k = torch.round(u * _INV_2PI)
    v = (u - k * _PI2_HI) - k * _PI2_LO
    v2 = v * v
    p = torch.full_like(v, _COS_C[6])
    for c in _COS_C[5::-1]:
        p = p * v2 + c
    return p


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x``: ``(..., C)``; ``alpha``: ``(C,)``. Computes in f32, returns x's dtype."""
    xf = x.float()
    a = alpha.float()
    c = cos_fast(2.0 * a * xf)
    return (xf + (1.0 - c) / (2.0 * (a + 1e-9))).to(x.dtype)
