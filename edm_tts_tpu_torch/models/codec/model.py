"""The neural codec, decode side (port of edm_tts_tpu/models/codec/model.py).

Layouts as in the JAX package: codes ``(B, Q, T50)``; features
``(B, T50, D)``; audio ``(B, T50 * hop + 16, 1)`` (the stride-5 block adds 2
samples before the last two upsamplings).
"""

from __future__ import annotations

import torch
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
                                    config.codebook_size, config.codebook_dim, device=device)
        self.decoder = Decoder(config.latent_dim, config.decoder_dim, config.decoder_rates, **kw)

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
        return self.decoder(self.quantizer.from_codes(codes).to(self.dtype), valid_frames)

    def codes_to_features(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` -> summed quantized features ``(B, T, D)`` (f32)."""
        return self.quantizer.from_codes(codes)

    def codes_to_features_unreduced(self, codes: torch.Tensor) -> torch.Tensor:
        """``(B, Q', T)`` -> per-level features ``(B, Q', T, D)`` (f32)."""
        return self.quantizer.from_codes_unreduced(codes)
