"""ITU-R BS.1770-4 gated loudness + volume normalization.

Replaces the reference's ``audiotools.AudioSignal`` loudness usage (its
dataset loader's -40 dB silence filter and -16 dBFS volume normalize; its
audio tokenizer normalizes before the acoustic encode):

- K-weighting: RBJ high-shelf (f0=1681.97 Hz, G=+4 dB, Q=0.7071) followed by
  a high-pass (f0=38.135 Hz, Q=0.5003), coefficients generated for the
  actual sample rate;
- 400 ms blocks with 75% overlap, absolute gate -70 LUFS, relative gate
  -10 LU, mono channel weight 1.0;
- signals shorter than 0.5 s are zero-padded (audiotools behavior).

Host-side numpy and scipy: a copy of edm_tts_tpu/ops/loudness.py
(``k_weight``, ``integrated_loudness``, ``normalize_loudness``), pinned
bit-equal to it in tests/test_torch_tokenizer.py. The JAX module's
on-device IIR (``biquad_scan``) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter


def _high_shelf(fs: float, f0: float = 1681.9744509555319, gain_db: float = 3.99984385397, q: float = 0.7071752369554196):
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b = np.array([
        A * ((A + 1) + (A - 1) * cw + 2 * math.sqrt(A) * alpha),
        -2 * A * ((A - 1) + (A + 1) * cw),
        A * ((A + 1) + (A - 1) * cw - 2 * math.sqrt(A) * alpha),
    ])
    a = np.array([
        (A + 1) - (A - 1) * cw + 2 * math.sqrt(A) * alpha,
        2 * ((A - 1) - (A + 1) * cw),
        (A + 1) - (A - 1) * cw - 2 * math.sqrt(A) * alpha,
    ])
    return b / a[0], a / a[0]


def _high_pass(fs: float, f0: float = 38.13547087602444, q: float = 0.5003270373238773):
    w0 = 2.0 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return b / a[0], a / a[0]


def k_weight(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """Apply the BS.1770 K-weighting pre-filter chain along the last axis."""
    b1, a1 = _high_shelf(sample_rate)
    b2, a2 = _high_pass(sample_rate)
    y = lfilter(b1, a1, audio, axis=-1)
    return lfilter(b2, a2, y, axis=-1)


def integrated_loudness(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """Gated integrated loudness (LUFS) per batch row.

    Args:
      audio: ``(..., T)`` mono waveform in [-1, 1].
    Returns loudness ``(...)`` in LUFS (min clamped to -70, audiotools-style).
    """
    audio = np.atleast_2d(np.asarray(audio, dtype=np.float64))
    t_min = int(0.5 * sample_rate)
    if audio.shape[-1] < t_min:
        pad = t_min - audio.shape[-1]
        audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])

    kw = k_weight(audio, sample_rate)
    block = int(0.400 * sample_rate)
    step = int(0.100 * sample_rate)
    t = kw.shape[-1]
    n_blocks = max(1 + (t - block) // step, 1)
    idx = np.arange(n_blocks)[:, None] * step + np.arange(block)[None, :]
    frames = kw[..., idx]  # (..., n_blocks, block)
    z = np.mean(frames**2, axis=-1)  # mean square per block
    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))

    out = np.empty(audio.shape[:-1])
    flat_z = z.reshape(-1, n_blocks)
    flat_l = l_blocks.reshape(-1, n_blocks)
    for i in range(flat_z.shape[0]):
        zi, li = flat_z[i], flat_l[i]
        above_abs = li > -70.0
        if not above_abs.any():
            out.flat[i] = -70.0
            continue
        rel_thresh = -0.691 + 10.0 * np.log10(np.mean(zi[above_abs])) - 10.0
        gated = above_abs & (li > rel_thresh)
        if not gated.any():
            out.flat[i] = -70.0
            continue
        lufs = -0.691 + 10.0 * np.log10(np.mean(zi[gated]))
        out.flat[i] = max(lufs, -70.0)
    return out.reshape(audio.shape[:-1])


def normalize_loudness(
    audio: np.ndarray, sample_rate: int, target_db: float = -16.0
) -> tuple[np.ndarray, np.ndarray]:
    """Gain the signal to the target LUFS and clip-protect (audiotools
    ``normalize`` + ``ensure_max_of_audio``).

    Returns (normalized audio, input loudness)."""
    loud = integrated_loudness(audio, sample_rate)
    gain_db = target_db - loud
    y = audio * (10.0 ** (gain_db / 20.0))[..., None]
    peak = np.max(np.abs(y), axis=-1, keepdims=True)
    y = y * np.minimum(1.0, 1.0 / np.maximum(peak, 1e-12))
    return y.astype(np.float32), loud
