"""Joint audio tokenizer: aligned acoustic (codec RVQ) and semantic (HuBERT
k-means) codes from raw 16 kHz audio (port of
edm_tts_tpu/models/tokenizer/audio_tokenizer.py).

- ``pad`` is the reference's alignment hack, bit for bit: pad to the next
  hop (320) multiple, split left/right, then hop/4 = 80 more samples on
  each side, which makes the codec's and HuBERT's conv stacks give the same
  number of frames;
- loudness normalization to -16 LUFS (BS.1770, ``ops.loudness``) runs on
  the host; the codec encodes the normalized audio, HuBERT the padded
  audio as it is;
- ``get_code_lengths`` walks the encoder's conv arithmetic.

The device work (codec encode, RVQ, HuBERT, nearest centroid; ``run_steps``,
one step at a time) runs on the codec's device, in the dtype each model was
built in. On the card, in bf16, the encoder's residual units run as K1 and
HuBERT's attention as K3; in f32 (the JAX tokenizer's default) the units
run the plain composition, as the JAX codec picks them, and HuBERT's
attention K3's f32 kernel, with TF32 off for the whole run
(``ops.precision.exact_f32``: cuDNN's f32 convolutions would otherwise take
TF32). ``compute_codes_from_file`` reads a WAV or FLAC file
(``data.audio_io``) and resamples it on the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from edm_tts_tpu_torch.models.codec import Codec
from edm_tts_tpu_torch.models.tokenizer.semantic_hubert import SemanticTokenizerHubert
from edm_tts_tpu_torch.ops.convolution import encoder_output_length
from edm_tts_tpu_torch.ops.loudness import normalize_loudness
from edm_tts_tpu_torch.ops.precision import exact_f32


class AudioTokenizer:
    def __init__(self, codec: Codec, semantic: SemanticTokenizerHubert | None):
        """``semantic=None`` makes a codec-only tokenizer: ``compute_codes``
        needs both models."""
        self.codec = codec
        self.semantic = semantic
        self.sample_rate = codec.config.sample_rate
        if semantic is not None and semantic.sample_rate != self.sample_rate:
            raise ValueError(f"codec at {self.sample_rate} Hz, HuBERT at "
                             f"{semantic.sample_rate} Hz")

    @property
    def downsample_factor(self) -> int:
        return self.codec.config.hop_length

    @property
    def device(self) -> torch.device:
        return self.codec.quantizer.quantizers[0].codebook.weight.device

    def pad(self, audio: np.ndarray) -> np.ndarray:
        """The alignment pad (host side) along the last axis."""
        d = self.downsample_factor
        t = audio.shape[-1]
        pad_val = (d - t % d) % d
        left, right = pad_val // 2, pad_val - pad_val // 2
        extra = d // 4
        return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(left + extra, right + extra)])

    def _check(self) -> None:
        if self.semantic is None:
            raise ValueError("this tokenizer has no semantic model (HuBERT + k-means)")

    def _precision(self):
        """``exact_f32`` when a model runs in f32 on the card, else nothing."""
        f32 = torch.float32 in (self.codec.dtype, self.semantic.dtype)
        return exact_f32() if f32 and self.device.type == "cuda" else contextlib.nullcontext()

    # the device steps, in order, as ``run_steps`` names them
    STEPS = ("codec encoder", "RVQ", "HuBERT conv stack", "HuBERT layers", "k-means")

    @torch.no_grad()
    def run_steps(self, normalized_audio, padded_audio, attention_mask=None,
                  step=None) -> dict[str, torch.Tensor]:
        """``compute_codes_batch``'s device work, one step of ``STEPS`` at a
        time, each run as ``step(name, fn)`` (by default ``fn()``; a profiler
        times them), with TF32 off when a model is f32 on the card. Returns
        the encoder's ``latents`` ``(B, T', D)``, ``acoustic_codes`` ``(B, Q,
        T')``, HuBERT's ``states`` ``(B, T', H)`` and ``semantic_codes``
        ``(B, T')``."""
        with self._precision():
            return self._run_steps(normalized_audio, padded_audio, attention_mask,
                                   step or (lambda name, fn: fn()))

    def _run_steps(self, normalized_audio, padded_audio, attention_mask, step):
        dev, sem = self.device, self.semantic
        normalized = torch.as_tensor(normalized_audio, device=dev).float()
        padded = torch.as_tensor(padded_audio, device=dev).float()
        mask = None if attention_mask is None else torch.as_tensor(attention_mask, device=dev)
        latents = step("codec encoder", lambda: self.codec.encoder(normalized[..., None]))
        acoustic = step("RVQ", lambda: self.codec.quantizer(latents)["codes"])
        x, frame_mask = step("HuBERT conv stack", lambda: sem.features(padded, mask))
        states = step("HuBERT layers", lambda: sem.states(x, frame_mask))
        semantic = step("k-means", lambda: sem.ids(states))
        return {"latents": latents, "acoustic_codes": acoustic, "states": states,
                "semantic_codes": semantic}

    def compute_codes_batch(self, normalized_audio, padded_audio,
                            attention_mask=None) -> dict[str, torch.Tensor]:
        """Pre-collated batches, already padded and normalized on the host:
        ``(B, T)`` each, ``attention_mask`` ``(B, T)`` (1 on valid samples)
        for HuBERT. Returns ``acoustic_codes`` ``(B, Q, T')`` and
        ``semantic_codes`` ``(B, T')``, int64 on the codec's device."""
        self._check()
        out = self.run_steps(normalized_audio, padded_audio, attention_mask)
        return {"acoustic_codes": out["acoustic_codes"], "semantic_codes": out["semantic_codes"]}

    def prepare(self, audio_batch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``compute_codes``' host side: the padded audio, it loudness-
        normalized to -16 LUFS, and its input loudness ``(B,)``."""
        padded = self.pad(np.asarray(audio_batch, np.float32))
        normalized, input_db = normalize_loudness(padded, self.sample_rate, -16.0)
        return padded, normalized, input_db

    def compute_codes(self, audio_batch) -> dict:
        """``(B, T)`` host waveform at 16 kHz -> aligned codes.

        Returns ``acoustic_codes`` ``(B, Q, T')``, ``semantic_codes``
        ``(B, T')`` (int64, on the codec's device) and ``input_db``, the
        input loudness in LUFS ``(B,)``. Raises ValueError when the two
        streams' frame counts differ.
        """
        padded, normalized, input_db = self.prepare(audio_batch)
        out = self.compute_codes_batch(normalized, padded)
        a, s = out["acoustic_codes"], out["semantic_codes"]
        if a.shape[-1] != s.shape[-1]:
            raise ValueError(f"acoustic/semantic code length mismatch: {tuple(a.shape)} vs "
                             f"{tuple(s.shape)}")
        return {**out, "input_db": input_db}

    def compute_codes_from_file(self, file_path: str, offset: int = 0,
                                num_frames: int = -1) -> dict:
        """Read an audio file (WAV or FLAC; ``offset`` and ``num_frames`` in
        samples), resample its first channel to 16 kHz on the host and
        tokenize it (``compute_codes``)."""
        from edm_tts_tpu_torch.data.audio_io import load_audio
        from edm_tts_tpu_torch.ops.resample import resample_numpy

        audio, sr = load_audio(file_path, offset, num_frames)
        wav = audio[0]
        if sr != self.sample_rate:
            wav = resample_numpy(wav, sr, self.sample_rate)
        return self.compute_codes(wav[None])

    def get_code_lengths(self, input_lengths) -> np.ndarray:
        """Frames for (padded) audio lengths: the encoder's conv arithmetic."""
        return np.asarray(encoder_output_length(np.asarray(input_lengths),
                                                self.codec.config.encoder_rates))
