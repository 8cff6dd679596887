"""Rotary position embeddings (port of edm_tts_tpu/ops/rope.py).

The frequency vector is concatenated with itself (not interleaved) and
``rotate_half`` splits the head dim into two contiguous halves.
"""

from __future__ import annotations

import torch


def rope_frequencies(
    seq_len: int, dim: int, *, theta: float = 10000.0, device=None
) -> torch.Tensor:
    """``(seq_len, dim)`` f32 angle matrix."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``: ``(..., seq, dim)``; ``freqs`` broadcasts against it."""
    cos = torch.cos(freqs).to(t.dtype)
    sin = torch.sin(freqs).to(t.dtype)
    return t * cos + rotate_half(t) * sin
