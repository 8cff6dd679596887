"""HuBERT encoder configuration (port of edm_tts_tpu/models/hubert/config.py,
a copy pinned equal to it in tests/test_torch_hubert.py).

Defaults match ``facebook/hubert-large-ll60k``, the reference's frozen
semantic feature extractor: a 7-layer conv feature extractor (downsample
320, receptive field 400) with a LayerNorm over channels after each conv
("layer" feat_extract_norm), a 1024-d 24-layer pre-LN ("stable layer
norm") transformer, and a conv positional embedding (k=128, 16 groups).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    feat_proj_layer_norm: bool = True

    @property
    def downsample_factor(self) -> int:
        out = 1
        for s in self.conv_stride:
            out *= s
        return out

    def feature_lengths(self, input_lengths):
        """Conv-stack output lengths (no padding): floor((L - k)/s) + 1 per layer."""
        out = input_lengths
        for k, s in zip(self.conv_kernel, self.conv_stride):
            out = (out - k) // s + 1
        return out


HUBERT_LARGE_LL60K = HubertConfig()

HUBERT_TINY_TEST = HubertConfig(
    conv_dim=(16, 16),
    conv_kernel=(10, 3),
    conv_stride=(5, 2),
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=4,
    intermediate_size=64,
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
