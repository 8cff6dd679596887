"""Text->semantic configuration (copy of edm_tts_tpu/models/t2s/config.py).

Copied rather than imported: the JAX module pulls in flax through its
ConformerConfig. The fields, defaults, JSON form and ``SPECIAL_TOKENS`` are
pinned equal to the original by tests/test_torch_ops.py.
"""

from __future__ import annotations

import dataclasses
import json
import os

from edm_tts_tpu_torch.models.conformer.conformer import ConformerConfig

SPECIAL_TOKENS = {"pad": 0, "text": 1, "speech": 2, "sep": 3, "mask": 4}


@dataclasses.dataclass(frozen=True)
class T2SConfig:
    hidden_size: int = 512
    semantic_vocab_size: int = 1024
    text_vocab_size: int = 256

    main_encoder_num_heads: int = 16
    # per-head width override; the reference's published recipe runs
    # heads 8 x dim_head 24 inside hidden 384. None = hidden // num_heads.
    main_encoder_dim_head: int | None = None
    main_encoder_num_layers: int = 8
    main_encoder_ff_mult: int = 4
    main_encoder_conv_kernel_size: int = 5
    main_encoder_attn_dropout: float = 0.0
    main_encoder_ff_dropout: float = 0.0
    main_encoder_conv_dropout: float = 0.0

    length_predictor_num_heads: int = 16
    length_predictor_dim_head: int | None = None
    length_predictor_num_layers: int = 4
    length_predictor_ff_mult: int = 4
    length_predictor_conv_kernel_size: int = 5
    length_predictor_attn_dropout: float = 0.0
    length_predictor_ff_dropout: float = 0.0
    length_predictor_conv_dropout: float = 0.0
    gradient_checkpointing: bool = False
    remat_policy: str = "dots"
    attn_implementation: str = "auto"
    quantize: str = "none"

    @property
    def num_special_tokens(self) -> int:
        return len(SPECIAL_TOKENS)

    @property
    def total_num_tokens(self) -> int:
        return self.text_vocab_size + self.semantic_vocab_size + self.num_special_tokens

    @property
    def semantic_offset(self) -> int:
        """Joint-vocab id of semantic token 0 (= 5 + 256 = 261)."""
        return self.num_special_tokens + self.text_vocab_size

    @property
    def main_encoder_config(self) -> ConformerConfig:
        return ConformerConfig(
            dim=self.hidden_size,
            depth=self.main_encoder_num_layers,
            dim_head=(self.main_encoder_dim_head
                      or self.hidden_size // self.main_encoder_num_heads),
            heads=self.main_encoder_num_heads,
            ff_mult=self.main_encoder_ff_mult,
            conv_kernel_size=self.main_encoder_conv_kernel_size,
            attn_dropout=self.main_encoder_attn_dropout,
            ff_dropout=self.main_encoder_ff_dropout,
            conv_dropout=self.main_encoder_conv_dropout,
            remat=self.gradient_checkpointing,
            remat_policy=self.remat_policy,
            attn_implementation=self.attn_implementation,
            quantize=self.quantize,
        )

    @property
    def length_predictor_config(self) -> ConformerConfig:
        return ConformerConfig(
            dim=self.hidden_size,
            depth=self.length_predictor_num_layers,
            dim_head=(self.length_predictor_dim_head
                      or self.hidden_size // self.length_predictor_num_heads),
            heads=self.length_predictor_num_heads,
            ff_mult=self.length_predictor_ff_mult,
            conv_kernel_size=self.length_predictor_conv_kernel_size,
            attn_dropout=self.length_predictor_attn_dropout,
            ff_dropout=self.length_predictor_ff_dropout,
            conv_dropout=self.length_predictor_conv_dropout,
            attn_implementation=self.attn_implementation,
            quantize=self.quantize,
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["model_type"] = "text_to_semantic_w_length"
        return json.dumps(d, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "T2SConfig":
        d = {k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}}
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "T2SConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_dict(json.load(f))
