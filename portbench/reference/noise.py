"""The samplers' positional noise, written out from its definition.

A counter hash (lowbias32) keyed by ``(seed, b * 2**20 + t, n)`` gives a
uniform in (0, 1) per position and lane; the categorical draw is the
gumbel-argmax ``argmax(logits - log(-log u))``. The per-iteration seeds come
from a CPU ``torch.Generator`` seeded with the request's seed, two per
iteration, the t2s sampler's iterations first and the s2a sampler's after.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x, m: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def positional_uniform(seed: int, rows: torch.Tensor, length: int, lanes: int) -> torch.Tensor:
    """Uniform (0, 1) f32 ``(len(rows), length, lanes)``; ``rows`` are the
    row indices within the engine call's batch."""
    b = rows.to(torch.int64)[:, None]
    t = torch.arange(length, dtype=torch.int64, device=rows.device)[None, :]
    h = _hash32((b * (1 << 20) + t) ^ _hash32(seed & _MASK32))[..., None]
    n = torch.arange(lanes, dtype=torch.int64, device=rows.device)
    h = _hash32((h + n) & _MASK32)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel_lanes(seed: int, rows: torch.Tensor, length: int, lanes: int) -> torch.Tensor:
    """The gumbel noise the categorical draw adds to the logits."""
    return -torch.log(-torch.log(positional_uniform(seed, rows, length, lanes)))


def iteration_seeds(seed: int, t2s_iters: int, s2a_iters: int) -> tuple[list, list]:
    """``([(sample, mask)] * t2s_iters, [(sample, mask)] * s2a_iters)``: the
    seeds one engine call draws from its generator."""
    gen = torch.Generator().manual_seed(seed)
    draw = [torch.randint(0, 2**31 - 1, (2,), generator=gen).tolist()
            for _ in range(t2s_iters + s2a_iters)]
    return draw[:t2s_iters], draw[t2s_iters:]
