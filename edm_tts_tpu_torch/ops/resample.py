"""Polyphase windowed-sinc resampling (port of edm_tts_tpu/ops/resample.py;
torchaudio.functional.resample semantics, torchaudio being absent on the
card's machine).

After gcd reduction of the two rates, one bank of ``new`` phase filters
(Hann-windowed sinc, lowpass_filter_width 6, rolloff 0.99) is built on the
host and applied as one strided ``F.conv1d`` with ``stride = orig`` on the
tensor's device, each output step giving ``new`` samples. The product is
f32 and exact (``exact_f32``: no TF32 on the card).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from edm_tts_tpu_torch.ops.precision import exact_f32


@functools.lru_cache(maxsize=32)
def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """``(kernels (new_freq, 2 * width + orig_freq) f32, width)`` for rates
    already reduced by their gcd."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t_pi = t * math.pi
    kernel = np.where(t_pi == 0, 1.0, np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """``(..., T)`` -> f32 ``(..., ceil(T * new_freq / orig_freq))`` on x's device."""
    if orig_freq == new_freq:
        return x.float()
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = orig_freq // g, new_freq // g
    kernels, width = _resample_kernel(orig, new)
    t = x.shape[-1]
    target_len = int(math.ceil(new * t / orig))
    lead = x.shape[:-1]
    xf = F.pad(x.reshape(-1, 1, t).float(), (width, width + orig))
    weight = torch.from_numpy(kernels).to(x.device)[:, None, :]  # (new, 1, taps)
    with exact_f32():
        y = F.conv1d(xf, weight, stride=orig)  # (N, new, T // orig + 1)
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :target_len]
    return y.reshape(*lead, target_len)


def resample_numpy(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host version of ``resample`` (the same bank, on the CPU)."""
    return resample(torch.from_numpy(np.asarray(x, np.float32)), orig_freq, new_freq).numpy()
