"""MaskGIT masking and sampling primitives (port of edm_tts_tpu/ops/masking.py).

The training mask (``cosine_schedule_mask``) draws from an explicit
``torch.Generator``; it cannot reproduce ``jax.random``, so the training
parity tests hand both packages the same mask.

The samplers' randomness is a counter-based hash in plain torch integer
ops, keyed by (seed, b * 2**20 + t [, n]): the draw at position (b, t) does
not depend on the canvas length, which is what ``positional_keys`` gives
the JAX package (bucketed canvases sample like exact-size ones). It runs
the same on the CPU and the card. It does not reproduce ``jax.random``'s
bits; the parity tests hand both packages the same noise instead. A part of
a batch (an engine replica's rows) passes its first row's index as
``row_offset``, so it draws what the whole batch draws there.
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """``(x * m) mod 2**32`` for ``x`` in [0, 2**32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def _hash32(x):
    """A 32-bit integer mixer (lowbias32) on Python ints or int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _positional_uniform(
    seed: int, batch: int, length: int, lanes: int, device, row_offset: int = 0
) -> torch.Tensor:
    """Uniform (0, 1) f32 ``(batch, length, lanes)`` keyed by position; the
    rows are rows ``row_offset...`` of a larger batch (a replica's part)."""
    b = torch.arange(row_offset, row_offset + batch, dtype=torch.int64, device=device)[:, None]
    t = torch.arange(length, dtype=torch.int64, device=device)[None, :]
    counter = b * (1 << 20) + t
    h = _hash32(counter ^ _hash32(seed & _MASK32))[..., None]
    n = torch.arange(lanes, dtype=torch.int64, device=device)
    h = _hash32((h + n) & _MASK32)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def positional_gumbel(seed: int, batch: int, length: int, *, device=None,
                      row_offset: int = 0) -> torch.Tensor:
    """Canvas-size-invariant gumbel noise ``(batch, length)`` of rows
    ``row_offset...``."""
    u = _positional_uniform(seed, batch, length, 1, device, row_offset)[..., 0]
    return -torch.log(-torch.log(u))


def positional_categorical(seed: int, logits: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Gumbel-argmax sample per position: ``(B, T, N)`` -> ``(B, T)`` int64
    (rows ``row_offset...``)."""
    b, t, n = logits.shape
    u = _positional_uniform(seed, b, t, n, logits.device, row_offset)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sampling_mask_ratios(steps: int, *, device=None) -> torch.Tensor:
    """``cos(pi/2 * (t+1)/steps)`` for t in [0, steps), f32."""
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=device) / steps
    return torch.cos(math.pi / 2.0 * t)


def random_topk_mask(
    mask_len: torch.Tensor,
    probs: torch.Tensor,
    *,
    temperature: float | torch.Tensor,
    gumbel: torch.Tensor,
) -> torch.Tensor:
    """Re-mask the ``mask_len`` lowest-confidence positions per row.

    Confidence is ``log(probs) + temperature * gumbel``; the ``mask_len``-th
    smallest is the cut-off and everything strictly below it is re-masked.
    Positions that must never be re-masked carry ``probs = +inf``.
    Returns bool ``(B, T)``, True = masked.
    """
    confidence = torch.log(probs) + temperature * gumbel
    sorted_conf, _ = torch.sort(confidence, dim=-1)
    idx = mask_len.to(torch.int64).clamp(0, probs.shape[-1] - 1)
    cut_off = torch.gather(sorted_conf, -1, idx[:, None])
    return confidence < cut_off


def cosine_schedule_mask(
    generator: torch.Generator, batch_size: int, length: int, *, device=None
) -> torch.Tensor:
    """Bernoulli mask with rate ``cos(u)``, one ``u ~ U(0, pi/2)`` per row.

    Returns bool ``(batch_size, length)``, True = masked.
    """
    u = torch.rand(batch_size, 1, generator=generator, device=device) * (math.pi / 2)
    return torch.rand(batch_size, length, generator=generator, device=device) < torch.cos(u)


def masked_mean(values: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-9) -> torch.Tensor:
    """Mean of ``values`` over the positions where ``mask`` is True."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / (mask.sum() + eps)
