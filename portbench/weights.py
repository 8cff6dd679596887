"""Seeded random weights, made on the device in a few large calls.

Every normally drawn leaf comes out of one ``randn`` and every uniformly
drawn leaf out of one ``rand`` of a ``torch.Generator`` on the device, then
each leaf is scaled by its rule:

- linears and pointwise convs: N(0, 1/fan_in); the stacked logits head
  N(0, 1/hidden);
- weight-normed and depthwise convs: U(+-1/sqrt(fan_in)), with
  ``weight_g = ||weight_v||`` so that the kernel is ``v``;
- embeddings, codebooks and learned tokens: N(0, 1);
- snake alphas: U(0.5, 2), so that a decode exercises them;
- norm scales 1, biases 0.

The same state dict goes to the port (``load_into``) and to the reference.
"""

from __future__ import annotations

import math

import torch

_M64 = (1 << 64) - 1


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed of ``stream`` under ``seed`` (splitmix64)."""
    x = (seed + 0x9E3779B97F4A7C15 * (stream + 1)) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def rule(name: str, shape: tuple[int, ...]) -> tuple[str, float]:
    """``(kind, scale)``: kind "normal" (std), "uniform" (bound), "const"
    (value) or "norm_of_v"."""
    if name.endswith(".weight_g"):
        return "norm_of_v", 0.0
    if name.endswith(".weight_v") or name.endswith(".4.conv.weight"):
        return "uniform", 1.0 / math.sqrt(math.prod(shape[1:]))
    if name.endswith(".alpha"):
        return "alpha", 0.0
    if name.endswith("bias"):
        return "const", 0.0
    if "embedding" in name or "codebook" in name or name in ("length_token", "mask_token"):
        return "normal", 1.0
    if name.endswith("to_logits.1.weight"):
        return "normal", shape[1] ** -0.5
    if len(shape) == 1 or name.endswith("conv.net.6.weight"):
        return "const", 1.0
    return "normal", math.prod(shape[1:]) ** -0.5


@torch.no_grad()
def make_state(shapes: dict[str, tuple[int, ...]], seed: int, *, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """A state dict of ``shapes`` in ``dtype`` on ``device`` from ``seed``."""
    rules = {n: rule(n, s) for n, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(shapes[n]) for n, (k, _) in rules.items() if k == kind)
             for kind in ("normal", "uniform", "alpha")}
    pools = {kind: (torch.randn if kind == "normal" else torch.rand)(
        n, generator=gen, device=device) for kind, n in sizes.items()}
    offsets = dict.fromkeys(pools, 0)
    out: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        kind, scale = rules[name]
        n = math.prod(shape)
        if kind in pools:
            flat = pools[kind][offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            if kind == "normal":
                flat = flat * scale
            elif kind == "uniform":
                flat = (flat * 2.0 - 1.0) * scale
            else:
                flat = 0.5 + 1.5 * flat
            out[name] = flat.view(shape).to(dtype)
        elif kind == "const":
            out[name] = torch.full(shape, scale, dtype=dtype, device=device)
    for name, shape in shapes.items():
        if rules[name][0] == "norm_of_v":
            v = out[name[: -len("weight_g")] + "weight_v"].float()
            out[name] = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt() \
                .reshape(shape).to(dtype)
    del pools
    return {n: out[n] for n in shapes}


@torch.no_grad()
def load_into(module: torch.nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Load ``state`` into a port model strictly; the model's own buffers
    (token ids) are kept."""
    keys = module.state_dict().keys()
    buffers = {n: b for n, b in module.named_buffers() if n in keys}
    module.load_state_dict({**buffers, **state}, strict=True)
