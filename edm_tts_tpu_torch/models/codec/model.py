"""The neural codec (port of edm_tts_tpu/models/codec/model.py): waveform
<-> 12-level RVQ codes at 50 Hz.

Layouts as in the JAX package: audio in ``(B, T, 1)`` with T a hop
multiple (``pad_audio_to_hop``); codes ``(B, Q, T50)``; features
``(B, T50, D)``; decoded audio ``(B, T50 * hop + 16, 1)`` (the stride-5
block adds 2 samples before the last two upsamplings), which ``decode``
and ``forward`` trim to the input's length.

``forward`` is the training pass (encode -> quantize, with quantizer
dropout drawn from a ``torch.Generator`` or given as ``thresholds`` ->
decode), as the JAX ``Codec.__call__``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edm_tts_tpu_torch.models.codec.config import CodecConfig
from edm_tts_tpu_torch.models.codec.decoder import Decoder
from edm_tts_tpu_torch.models.codec.encoder import Encoder
from edm_tts_tpu_torch.models.codec.rvq import ResidualVQ


class Codec(nn.Module):
    def __init__(self, config: CodecConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        self.encoder = Encoder(config.encoder_dim, config.encoder_rates, **kw)
        self.quantizer = ResidualVQ(config.latent_dim, config.n_codebooks,
                                    config.codebook_size, config.codebook_dim,
                                    config.quantizer_dropout, device=device)
        self.decoder = Decoder(config.latent_dim, config.decoder_dim, config.decoder_rates, **kw)

    def pack(self) -> None:
        """Lay the encoder's and decoder's weights out as their kernels take
        them (after every load, and after a move to another device)."""
        self.encoder.pack()
        self.decoder.pack()

    def forward(self, audio: torch.Tensor, n_quantizers: int | None = None, *,
                train: bool = False, generator: torch.Generator | None = None,
                thresholds: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """The full encode -> quantize -> decode pass. ``audio``: ``(B, T, 1)``,
        T a hop multiple. Returns ``encode``'s entries and ``audio``
        ``(B, T, 1)`` in the model's dtype."""
        out = self.encode(audio, n_quantizers, train=train, generator=generator,
                          thresholds=thresholds)
        out["audio"] = self.decode(out["z"], length=audio.shape[-2])
        return out

    def encode(self, audio: torch.Tensor, n_quantizers: int | None = None, *,
               train: bool = False, generator: torch.Generator | None = None,
               thresholds: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """``(B, T, 1)`` waveform -> the quantizer's outputs
        (``ResidualVQ.forward``: ``z``, ``codes``, ``latents`` and the two VQ
        losses) and the encoder output ``z_e``."""
        z = self.encoder(audio)
        out = self.quantizer(z, n_quantizers, train=train, generator=generator,
                             thresholds=thresholds)
        out["z_e"] = z
        return out

    def decode(self, z: torch.Tensor, length: int | None = None,
               valid_frames: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, T50, D)`` latents -> waveform, trimmed to ``length`` samples
        when given (the decoder emits ``decoded_length(T50)``);
        ``valid_frames`` as in ``decode_from_codes``."""
        audio = self.decoder(z.to(self.dtype), valid_frames)
        return audio if length is None else audio[:, :length]

    def encode_to_codes(self, audio: torch.Tensor, n_quantizers: int | None = None) -> torch.Tensor:
        """``(B, T, 1)`` waveform -> ``(B, Q, T / hop)`` int64 codes."""
        return self.quantizer(self.encoder(audio), n_quantizers)["codes"]

    def decoded_length(self, n_frames: int) -> int:
        t = n_frames
        for s in self.config.decoder_rates:
            t = s * t + (2 if s % 2 else 0)
        return t

    def decode_from_codes(self, codes: torch.Tensor,
                          valid_frames: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, Q', T50)`` codes -> ``(B, decoded_length(T50), 1)`` waveform.

        ``valid_frames`` (optional int ``(B,)``): decode a padded canvas so
        that the first ``valid_frames[b] * hop`` samples of row b equal the
        decode of ``codes[b, :, :valid_frames[b]]`` (``Decoder.forward``).
        """
        return self.decode(self.quantizer.from_codes(codes), valid_frames=valid_frames)

    def codes_to_features(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` -> summed quantized features ``(B, T, D)`` (f32)."""
        return self.quantizer.from_codes(codes)

    def codes_to_features_unreduced(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` -> per-level features ``(B, Q', T, D)`` (f32)."""
        return self.quantizer.from_codes_unreduced(codes)

    def features_to_codes(self, features: torch.Tensor) -> torch.Tensor:
        """``(B, T, Q' * dc)`` projected latents -> ``(B, Q', T)`` codes."""
        return self.quantizer.from_latents(features)[-1]

    def features_to_codebook_logits(self, features: torch.Tensor) -> torch.Tensor:
        """``(B, T, D)`` -> residual squared distances ``(B, T, Q, N)``."""
        return self.quantizer.latents_to_codebook_dist(features)


def pad_audio_to_hop(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Right-pad a waveform ``(..., T, 1)`` with zeros to the next hop multiple."""
    t = audio.shape[-2]
    return F.pad(audio, (0, 0, 0, math.ceil(t / hop_length) * hop_length - t))
