"""Codec building blocks (port of edm_tts_tpu/models/codec/layers.py).

Inference-only: weight norm is folded once when the weights are loaded
(``edm_tts_tpu_torch.convert``), so ``WNConv1d`` / ``WNConvTranspose1d``
hold the effective ``weight`` and ``bias`` in torch's layouts
(``(C_out, C_in/groups, K)`` and ``(C_in, C_out, K)``), under the reference
DAC's key names. Activations are channel-last ``(B, T, C)``.

The loader then calls ``pack`` on the modules the decoder runs through the
kernels, which lays their weights out once as the kernels take them; a
change of the weights afterwards needs another ``pack``.

Which units take the kernel is the JAX package's "auto" rule
(edm_tts_tpu/models/codec/layers.py, ``ResidualUnit``): K1 for bf16
activations at C <= 768 (``resunit_uses_kernel``); otherwise (f32, wider
units) the plain composition on the module's own weights, on the card as on
the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.ops import conv1d, conv_transpose1d, fused_residual_unit, snake
from edm_tts_tpu_torch.ops.resunit import resunit_reference

# the widest unit the JAX package gives its Pallas kernel (its f32 weights
# at C 768 filled the TPU's VMEM; the rule is kept so both packages run the
# same units through their kernels)
RESUNIT_KERNEL_MAX_C = 768


def resunit_uses_kernel(x: torch.Tensor, channels: int) -> bool:
    """Whether a residual unit of ``channels`` runs K1 on ``x``: bf16 and
    C <= 768, as the JAX package's "auto" rule picks its Pallas kernel."""
    return x.dtype == torch.bfloat16 and channels <= RESUNIT_KERNEL_MAX_C


class Snake(nn.Module):
    """Per-channel snake; ``alpha`` is ``(1, C, 1)`` as in the reference."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha.view(-1))


class WNConv1d(nn.Module):
    """Conv1d with a folded weight-norm weight ``(C_out, C_in/groups, K)``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, C_in/groups, C_out)`` kernel (the JAX layout) and bias."""
        return self.weight.permute(2, 1, 0), self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.folded()
        return conv1d(x, kernel, bias, stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups)


class WNConvTranspose1d(nn.Module):
    """ConvTranspose1d with a folded weight ``(C_in, C_out, K)``.

    The reference normalises this weight per *input* channel (torch
    ``weight_norm(dim=0)``); the loader folds it that way.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, *, stride: int,
                 padding: int = 0, output_padding: int = 0, device=None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, C_in, C_out)`` kernel (the JAX layout) and bias."""
        return self.weight.permute(2, 0, 1), self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.folded()
        return conv_transpose1d(x, kernel, bias, stride=self.stride, padding=self.padding,
                                output_padding=self.output_padding)


class ResidualUnit(nn.Module):
    """Snake -> dilated k=7 conv -> snake -> k=1 conv, plus the input.

    ``block`` mirrors the reference's ``[Snake, WNConv1d, Snake, WNConv1d]``.
    Where ``resunit_uses_kernel`` says so, runs through
    ``ops.fused_residual_unit`` (kernel K1 on the card, the plain
    composition on the CPU) on the layouts ``pack`` made; otherwise the
    plain composition on ``folded()``.
    """

    def __init__(self, dim: int, dilation: int = 1, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dilation = dilation
        self.kernel_args: tuple[torch.Tensor, ...] | None = None
        self.block = nn.ModuleList([
            Snake(dim, **kw),
            WNConv1d(dim, dim, 7, dilation=dilation, padding=3 * dilation, **kw),
            Snake(dim, **kw),
            WNConv1d(dim, dim, 1, **kw),
        ])

    def folded(self) -> tuple[torch.Tensor, ...]:
        """``(alpha1, w7, b7, alpha2, w1, b1)`` in the kernels' argument layout."""
        s1, c7, s2, c1 = self.block
        w7, b7 = c7.folded()
        w1, b1 = c1.folded()
        return s1.alpha.view(-1), w7, b7, s2.alpha.view(-1), w1, b1

    @torch.no_grad()
    def pack(self) -> None:
        """Lay ``folded()`` out as K1 takes it: kernels contiguous in the
        module's dtype, alphas and biases contiguous f32."""
        a1, w7, b7, a2, w1, b1 = self.folded()
        self.kernel_args = (_f32(a1), w7.contiguous(), _f32(b7), _f32(a2),
                            w1.contiguous(), _f32(b1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_args is None:
            raise RuntimeError("ResidualUnit: weights not packed; load them through "
                               "edm_tts_tpu_torch.convert or call pack()")
        if not resunit_uses_kernel(x, self.block[1].weight.shape[0]):
            return resunit_reference(x, *self.folded(), dilation=self.dilation)
        return fused_residual_unit(x.contiguous(), *self.kernel_args, self.dilation)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()
