"""Long-form text chunking and waveform joining (copy of
edm_tts_tpu/serving/chunking.py).

The t2s canvas is bounded: the sampler allocates a ``max_speech_len``-frame
canvas (1250 frames, ~25 s at the 50 Hz frame rate), so one request carries
at most that much speech. Long-form synthesis splits the text at sentence
boundaries, packs the sentences greedily into chunks the canvas can hold,
synthesizes the chunks as batched engine calls (chunks of one document
become rows of one batch) and joins the per-chunk waveforms with a short
crossfade (or a silence gap).

Pure host-side string and array code, pinned equal to the JAX package's by
tests/test_torch_serving.py.
"""

from __future__ import annotations

import re

import numpy as np

# sentence enders followed by whitespace; the punctuation stays with its
# sentence (TTS prosody needs it)
_SENT_BOUNDARY = re.compile(r"(?<=[.!?…])\s+|(?<=[;:])\s+")


def split_text(text: str, max_chars: int) -> list[str]:
    """Split ``text`` into chunks of at most ``max_chars`` characters.

    Prefers sentence boundaries, then packs whole sentences greedily;
    a single sentence longer than ``max_chars`` is hard-split at its last
    interior space (mid-word only if it has no spaces at all). Whitespace
    runs are collapsed to single spaces and non-space content is never
    altered: ``" ".join(split_text(t, n))`` equals the whitespace-normalized
    ``t`` whenever no single word exceeds ``n`` (a mid-word hard split
    becomes a chunk boundary, i.e. one extra space).
    """
    if max_chars < 1:
        raise ValueError(f"max_chars must be >= 1, got {max_chars}")
    text = " ".join(text.split())
    if not text:
        raise ValueError("empty text")

    pieces: list[str] = []
    for sent in _SENT_BOUNDARY.split(text):
        while len(sent) > max_chars:
            cut = sent.rfind(" ", 1, max_chars + 1)
            if cut <= 0:
                cut = max_chars
            pieces.append(sent[:cut].strip())
            sent = sent[cut:].strip()
        if sent:
            pieces.append(sent)

    chunks: list[str] = []
    cur = ""
    for p in pieces:
        if not cur:
            cur = p
        elif len(cur) + 1 + len(p) <= max_chars:
            cur = f"{cur} {p}"
        else:
            chunks.append(cur)
            cur = p
    if cur:
        chunks.append(cur)
    return chunks


def join_waveforms(
    wavs: list[np.ndarray],
    sample_rate: int,
    *,
    crossfade_ms: float = 30.0,
    gap_ms: float = 0.0,
) -> np.ndarray:
    """Concatenate per-chunk waveforms into one float32 track.

    ``gap_ms > 0`` inserts silence between chunks (pause at a sentence /
    paragraph break) and disables the crossfade (fading into silence just
    shortens the audio); otherwise adjacent chunks are joined with a
    ``crossfade_ms`` equal-power (sin/cos) crossfade, clamped to the shorter
    of the two waveforms. Equal-power is the right law for splicing
    *uncorrelated* chunks (independent synthesis runs): the summed power
    stays flat through the joint, where a linear equal-gain ramp dips ~-3 dB
    at the midpoint. For *correlated* joint content (sustained voiced audio
    on both sides of a forced mid-sentence split) cos+sin peaks at sqrt(2),
    which could overshoot +3 dB and hard-clip downstream writers — so the
    blended region is renormalized by 1/max(1, peak) when it exceeds the
    louder of the two inputs' own peaks.
    """
    wavs = [np.asarray(w, dtype=np.float32).reshape(-1) for w in wavs]
    if not wavs:
        raise ValueError("no waveforms to join")
    n_gap = int(round(sample_rate * gap_ms / 1e3))
    n_fade = 0 if n_gap > 0 else int(round(sample_rate * crossfade_ms / 1e3))

    out = wavs[0]
    gap = np.zeros(n_gap, np.float32)
    for w in wavs[1:]:
        if n_gap > 0:
            out = np.concatenate([out, gap, w])
            continue
        n = min(n_fade, out.shape[0], w.shape[0])
        if n == 0:
            out = np.concatenate([out, w])
            continue
        theta = np.linspace(0.0, np.pi / 2, n, dtype=np.float32)
        a, b = out[-n:], w[:n]
        mixed = a * np.cos(theta) + b * np.sin(theta)
        # correlated-joint guard: equal-power sums to sqrt(2) gain when the
        # two sides are in phase; keep the splice no hotter than its louder
        # input so save_wav/_send_wav (both clip at +-1) never hard-clip it
        in_peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
        peak = np.abs(mixed).max()
        if peak > in_peak:
            mixed *= in_peak / peak
        out = np.concatenate([out[:-n], mixed, w[n:]])
    return out


def default_chunk_chars(max_speech_len: int, frame_rate_hz: int = 50) -> int:
    """Character budget per chunk for a given speech-canvas bound.

    Read speech runs ~12-15 chars/s; budget 12 against the canvas's
    ``max_speech_len / frame_rate_hz`` seconds so the t2s length predictor
    has headroom and never saturates the canvas (a saturated canvas would
    truncate audio mid-word). 1250 frames -> 300 chars.
    """
    return max(16, (max_speech_len * 12) // frame_rate_hz)
