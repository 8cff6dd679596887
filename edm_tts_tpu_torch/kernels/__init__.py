"""Hand-written CUDA kernels: build, bindings and launch counters.

``launches`` counts, per kernel, how many times its wrapper launched it on
the card, and ``f32_launches`` the same for K3's, K4's and K5's f32 kernels
(``all_launches`` joins the two); ``int8_dense_shapes`` counts K5's
launches per ``(M, K, N)`` and ``resunit_shapes`` K1's per ``(B, T, C,
dilation)``. They are the port's
global state: a run resets them, drives the main path and reads them back
to show which kernels the path went through, and at which shapes K5 and K1
ran. Wrappers that take the plain version (CPU tensors) do
not count.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch

KERNELS = ("resunit", "decoder_block", "attention", "attention_bwd", "int8_dense",
           "attn_variants")
# K3's, K4's and K5's f32 kernels, counted in ``f32_launches`` so that
# ``launches`` keeps one entry per TPU kernel
F32_KERNELS = ("attention_f32", "attention_bwd_f32", "int8_dense_f32")
# streaming multiprocessors of an H100 SXM (what the wrappers' tile choices
# assume when they are not told the card's count)
H100_SMS = 132

launches: dict[str, int] = {name: 0 for name in KERNELS}
f32_launches: dict[str, int] = {name: 0 for name in F32_KERNELS}
int8_dense_shapes: Counter[tuple[int, int, int]] = Counter()
resunit_shapes: Counter[tuple[int, int, int, int]] = Counter()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for name in F32_KERNELS:
        f32_launches[name] = 0
    int8_dense_shapes.clear()
    resunit_shapes.clear()


def all_launches() -> dict[str, int]:
    """Every kernel's count, the f32 kernels' included."""
    return {**launches, **f32_launches}


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward (K5, as the JAX package's ``int8_dense`` has no VJP): its
    output is not attached to the graph, so the gradient would be lost
    without a word. Call such kernels under ``torch.no_grad()`` or with
    inputs that do not require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (int8 K5 is inference-only, as the JAX "
            "package's int8_dense has no VJP); call it under torch.no_grad()")


class _PlainBackward(torch.autograd.Function):
    """Forward: ``launch(*tensors)``; backward: the VJP of ``plain(*tensors)``
    on the saved inputs, recomputed under ``enable_grad``."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(ctx.plain(*leaves), wanted, grad, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def with_plain_backward(launch, plain, *tensors: torch.Tensor) -> torch.Tensor:
    """``launch(*tensors)`` (a kernel), differentiable as ``plain(*tensors)``
    (its plain composition): the JAX package's ``custom_vjp`` whose backward
    is the VJP of the plain composition (K1's and K2's). The forward keeps
    the inputs, not the composition's intermediates; the backward
    recomputes them. Without a gradient to record, just ``launch``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainBackward.apply(launch, plain, *tensors)
    return launch(*tensors)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
