"""Codec (DAC) configuration (copy of edm_tts_tpu/models/codec/config.py).

16 kHz, hop 320 (strides 2*4*5*8), 12 codebooks x 1024 x dim-8. Copied so
that the port imports nothing of the JAX package; pinned equal to the
original by tests/test_torch_ops.py.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    sample_rate: int = 16000
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 5, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 5, 4, 2)
    n_codebooks: int = 12
    codebook_size: int = 1024
    codebook_dim: int = 8
    quantizer_dropout: float = 0.5

    @property
    def hop_length(self) -> int:
        return math.prod(self.decoder_rates)

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * 2 ** len(self.encoder_rates)

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["model_type"] = "codec"
        return json.dumps(d, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "CodecConfig":
        d = {k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}}
        for k in ("encoder_rates", "decoder_rates"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "CodecConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_dict(json.load(f))
