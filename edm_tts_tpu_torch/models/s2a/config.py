"""Semantic->acoustic configuration (copy of edm_tts_tpu/models/s2a/config.py).

Copied rather than imported: the JAX module pulls in flax. Pinned equal to
the original by tests/test_torch_ops.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

from edm_tts_tpu_torch.models.codec.config import CodecConfig
from edm_tts_tpu_torch.models.conformer.conformer import ConformerConfig


@dataclasses.dataclass(frozen=True)
class S2AConfig:
    hidden_size: int = 1024
    num_semantic_tokens: int = 1024
    encoder_num_heads: int = 16
    encoder_num_layers: int = 16
    encoder_ff_mult: int = 4
    encoder_conv_kernel_size: int = 5
    encoder_attn_dropout: float = 0.1
    encoder_ff_dropout: float = 0.1
    encoder_conv_dropout: float = 0.1
    injection_layers: Tuple[int, ...] = (4, 7, 10, 13)
    residual: bool = True
    use_injection: bool = True
    loss_all: bool = False
    gradient_checkpointing: bool = False
    remat_policy: str = "mha"
    attn_implementation: str = "auto"
    quantize: str = "none"
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)

    @property
    def encoder_config(self) -> ConformerConfig:
        return ConformerConfig(
            dim=self.hidden_size,
            depth=self.encoder_num_layers,
            dim_head=self.hidden_size // self.encoder_num_heads,
            heads=self.encoder_num_heads,
            ff_mult=self.encoder_ff_mult,
            conv_kernel_size=self.encoder_conv_kernel_size,
            attn_dropout=self.encoder_attn_dropout,
            ff_dropout=self.encoder_ff_dropout,
            conv_dropout=self.encoder_conv_dropout,
            remat=self.gradient_checkpointing,
            attn_implementation=self.attn_implementation,
            quantize=self.quantize,
        )

    @property
    def num_quantizers(self) -> int:
        return self.codec.n_codebooks

    @property
    def num_codevectors(self) -> int:
        return self.codec.codebook_size

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["model_type"] = "s2a_injection_conformer"
        return json.dumps(d, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "S2AConfig":
        d = dict(d)
        codec = d.pop("codec", None)
        d = {k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}}
        if "injection_layers" in d:
            d["injection_layers"] = tuple(d["injection_layers"])
        if codec is not None:
            d["codec"] = CodecConfig.from_dict(codec)
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "S2AConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_dict(json.load(f))
