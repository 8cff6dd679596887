"""Host-side audio file IO (a copy of edm_tts_tpu/data/audio_io.py, pinned
equal to it in tests/test_torch_hub.py): WAV via scipy, FLAC via the repo's
first-party decoder ``native/flac.cc`` (``data.native_flac``).

Supports frame_offset/num_frames windowed reads and header-only probing.
"""

from __future__ import annotations

import dataclasses
import os
import wave

import numpy as np


@dataclasses.dataclass(frozen=True)
class AudioInfo:
    sample_rate: int
    num_frames: int
    num_channels: int


def _wav_read(path: str, frame_offset: int = 0, num_frames: int = -1):
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[:, None]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    end = None if num_frames < 0 else frame_offset + num_frames
    return data[frame_offset:end].T, sr  # (C, T)


def _wav_info(path: str) -> AudioInfo:
    with wave.open(path, "rb") as w:
        return AudioInfo(w.getframerate(), w.getnframes(), w.getnchannels())


def load_audio(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> tuple[np.ndarray, int]:
    """Returns (audio (C, T) float32 in [-1, 1], sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return _wav_read(path, frame_offset, num_frames)
    if ext == ".flac":
        from edm_tts_tpu_torch.data.native_flac import flac_read

        return flac_read(path, frame_offset, num_frames)
    raise ValueError(f"unsupported audio format: {path}")


def audio_info(path: str) -> AudioInfo:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return _wav_info(path)
    if ext == ".flac":
        from edm_tts_tpu_torch.data.native_flac import flac_info

        return flac_info(path)
    raise ValueError(f"unsupported audio format: {path}")


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 ``(T,)`` / ``(C, T)`` audio as 16-bit PCM WAV."""
    from scipy.io import wavfile

    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio.T  # (T, C)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))
