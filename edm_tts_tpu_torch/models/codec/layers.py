"""Codec building blocks (port of edm_tts_tpu/models/codec/layers.py).

Weight norm as the JAX package holds it: every ``WNConv1d`` /
``WNConvTranspose1d`` keeps the direction ``weight_v`` and the magnitude
``weight_g`` as parameters under the reference DAC's key names (torch's
layouts, ``(C_out, C_in/groups, K)`` and ``(C_in, C_out, K)``; ``weight_g``
``(C, 1, 1)``), and the effective kernel is ``g * v / ||v||`` with the norm
over every dim but the first (torch ``weight_norm(dim=0)``: per output
channel for a conv, per *input* channel for the transposed conv).
Activations are channel-last ``(B, T, C)``.

``weight`` is that kernel. While autograd records and v or g requires
grad it is folded live, so that training reaches v and g; otherwise it is
the fold kept in the non-persistent buffer ``folded_weight``, made once
when the weights are loaded (``convert``) and made again only when v or g
change in place (an optimizer step, a load: their version counters move).
The loader then calls ``pack`` on the modules that run the kernels, which
lays their weights out once as the kernels take them; a change of the
weights afterwards needs another ``pack``.

Which units take the kernel is the JAX package's "auto" rule
(edm_tts_tpu/models/codec/layers.py, ``ResidualUnit``): K1 for bf16
activations at C <= 768 (``resunit_uses_kernel``); otherwise (f32, wider
units) the plain composition on the module's own weights, on the card as on
the CPU. Under autograd K1 takes the live weights, and its backward is the
plain composition's (``ops.resunit``).
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


def norm_but_first(v: torch.Tensor) -> torch.Tensor:
    """f32 ``||v||`` over every dim but the first, kept as size-1 dims (the
    norm torch's ``weight_norm(dim=0)`` takes; ``g``'s shape)."""
    vf = v.float()
    return torch.sqrt((vf * vf).sum(dim=tuple(range(1, v.dim())), keepdim=True))


def fold_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * v / ||v||`` (``norm_but_first``), computed in f32 and returned
    in v's dtype."""
    norm = norm_but_first(v)
    return (v.float() * (g.float().reshape(norm.shape) / norm)).to(v.dtype)


def records_grad(module: nn.Module) -> bool:
    """Whether autograd records through ``module``'s parameters now."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters())


class WeightNormed(nn.Module):
    """A parameter pair ``weight_v`` / ``weight_g`` whose effective kernel
    is ``weight``: folded live while autograd records through v or g, else
    the fold kept in ``folded_weight`` (made again when v or g changed in
    place since)."""

    def _weight_norm(self, shape: tuple[int, ...], device, dtype) -> None:
        self.weight_v = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.weight_g = nn.Parameter(
            torch.empty(shape[0], *(1,) * (len(shape) - 1), device=device, dtype=dtype))
        self.register_buffer("folded_weight", None, persistent=False)
        self._folded_from: tuple[int, int] | None = None

    def _versions(self) -> tuple[int, int]:
        return self.weight_v._version, self.weight_g._version

    @property
    def weight(self) -> torch.Tensor:
        v, g = self.weight_v, self.weight_g
        if torch.is_grad_enabled() and (v.requires_grad or g.requires_grad):
            return fold_weight(v, g)
        if self.folded_weight is None or self._folded_from != self._versions():
            self.fold()
        return self.folded_weight

    @torch.no_grad()
    def fold(self, weight: torch.Tensor | None = None) -> None:
        """Keep ``weight`` (by default the fold of v and g; the loader passes
        its f32 fold of the checkpoint's pair) as the inference kernel."""
        with torch.inference_mode(False):
            w = fold_weight(self.weight_v, self.weight_g) if weight is None else weight
            self.folded_weight = w.to(self.weight_v).detach()
        self._folded_from = self._versions()


class Snake(nn.Module):
    """Per-channel snake; ``alpha`` is ``(1, C, 1)`` as in the reference."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha.view(-1))


class WNConv1d(WeightNormed):
    """Weight-normed Conv1d, ``weight_v`` ``(C_out, C_in/groups, K)``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 device=None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self._weight_norm((cout, cin // groups, kernel_size), device, dtype)
        self.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, C_in/groups, C_out)`` kernel (the JAX layout) and bias."""
        return self.weight.permute(2, 1, 0), self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.folded()
        return conv1d(x, kernel, bias, stride=self.stride, padding=self.padding,
                      dilation=self.dilation, groups=self.groups)


class WNConvTranspose1d(WeightNormed):
    """Weight-normed ConvTranspose1d, ``weight_v`` ``(C_in, C_out, K)``,
    normalised per *input* channel (torch ``weight_norm(dim=0)``), as the
    reference holds it."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *, stride: int,
                 padding: int = 0, output_padding: int = 0, device=None, dtype=None):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self._weight_norm((cin, cout, kernel_size), device, dtype)
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
    composition on the CPU) on ``kernel_inputs``; otherwise the plain
    composition on ``folded()``.
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

    @staticmethod
    def _layout(folded, dtype) -> tuple[torch.Tensor, ...]:
        a1, w7, b7, a2, w1, b1 = folded
        return (_f32(a1), w7.to(dtype).contiguous(), _f32(b7), _f32(a2),
                w1.to(dtype).contiguous(), _f32(b1))

    @torch.no_grad()
    def pack(self) -> None:
        """Lay ``folded()`` out as K1 takes it: kernels contiguous in the
        module's dtype, alphas and biases contiguous f32."""
        self.kernel_args = self._layout(self.folded(), self.block[1].bias.dtype)

    def kernel_inputs(self, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        """K1's weight arguments: the packed ones, or, while autograd records
        through the unit, its live weights in the same layouts."""
        if records_grad(self):
            return self._layout(self.folded(), dtype)
        return self.kernel_args

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_args is None:
            raise RuntimeError("ResidualUnit: weights not packed; load them through "
                               "edm_tts_tpu_torch.convert or call pack()")
        if not resunit_uses_kernel(x, self.block[1].bias.shape[0]):
            return resunit_reference(x, *self.folded(), dilation=self.dilation)
        return fused_residual_unit(x.contiguous(), *self.kernel_inputs(x.dtype), self.dilation)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous f32 (differentiable)."""
    return t.to(torch.float32).contiguous()
