"""Spectral ops on ``torch.stft``: STFT, (mel) spectrograms, mel filterbanks
(port of edm_tts_tpu/ops/spectral.py; torchaudio is absent on the card's
machine).

torchaudio's semantics, as in the JAX package:

- ``center=True`` with reflect padding of ``n_fft // 2`` on both sides, so
  a signal of T samples gives ``1 + T // hop`` frames;
- periodic Hann window, ``win_length = n_fft``, ``hop = n_fft // 4`` unless
  given;
- mel filterbank: HTK mel scale, no norm, fmax None -> sr / 2.

Everything is f32 (the FFT on the card is cuFFT's); differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * torch.pi * n / win_length))


def stft(x: torch.Tensor, n_fft: int, hop_length: int | None = None,
         win_length: int | None = None, *, center: bool = True,
         pad_mode: str = "reflect") -> torch.Tensor:
    """Complex STFT ``(..., n_fft // 2 + 1, n_frames)`` (freq, time)."""
    hop = hop_length or n_fft // 4
    win_length = win_length or n_fft
    lead, t = x.shape[:-1], x.shape[-1]
    spec = torch.stft(x.float().reshape(-1, t), n_fft, hop_length=hop, win_length=win_length,
                      window=hann_window(win_length, x.device), center=center,
                      pad_mode=pad_mode, normalized=False, onesided=True, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int | None = None, *,
                power: float | None = 1.0, center: bool = True) -> torch.Tensor:
    """Magnitude (power 1), power (power 2) or complex (power None)
    spectrogram: torchaudio.transforms.Spectrogram's semantics."""
    s = stft(x, n_fft, hop_length, center=center)
    if power is None:
        return s
    mag = s.abs()
    if power == 1.0:
        return mag
    return mag ** power


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=64)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Triangular mel filterbank ``(n_fft // 2 + 1, n_mels)`` (HTK scale, no
    norm: torchaudio ``melscale_fbanks``' defaults)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    f_pts = _mel_to_hz_htk(mel_pts)
    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int, n_mels: int,
                    hop_length: int | None = None, *, fmin: float = 0.0,
                    fmax: float | None = None, power: float = 1.0) -> torch.Tensor:
    """``(..., T)`` -> mel spectrogram ``(..., n_mels, n_frames)``, ``power``
    applied before the mel projection (torchaudio.transforms.MelSpectrogram)."""
    spec = spectrogram(x, n_fft, hop_length, power=power)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(x.device)
    return torch.einsum("...ft,fm->...mt", spec, fb)
