"""Hand-written CUDA kernels: build, bindings and launch counters.

``launches`` counts, per kernel, how many times its wrapper launched it on
the card. It is the one piece of global state in the port: a run resets it,
drives the main path and reads it back to show which kernels the path went
through. Wrappers that take the plain version (CPU tensors) do not count.
"""

from __future__ import annotations

import torch

KERNELS = ("resunit", "decoder_block", "attention", "attention_bwd", "int8_dense")

launches: dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward (K1, K2 and K5): its output is not attached to the graph, so
    the gradient would be lost without a word. Call such kernels under
    ``torch.no_grad()`` or with inputs that do not require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (the codec kernels K1/K2 get theirs "
            "with the codec-training slice; int8 K5 is inference-only); call it under "
            "torch.no_grad()")
