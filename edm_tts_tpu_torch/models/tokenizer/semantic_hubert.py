"""Semantic tokenizer: HuBERT layer-18 features -> k-means ids (port of
edm_tts_tpu/models/tokenizer/semantic_hubert.py).

``encode`` normalizes each waveform to zero mean and unit variance, runs
HuBERT to ``output_layer`` (18 for hubert-large-ll60k) and gives each frame
the id of its nearest centroid (``ops.kmeans.assign``: the f32 three-term
squared distance, no TF32), one id per 320 input samples. The centroids
are the ``(K, H)`` f32 buffer ``cluster_centers``, in the state dict beside
HuBERT's weights; the model runs in the dtype it was built in (the JAX
package's default is f32; on the card the kernels take bf16 only). The
three steps are methods of their own (``features``, ``states``, ``ids``),
which ``AudioTokenizer.run_steps`` calls one at a time.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.hubert import HubertConfig, HubertModel, normalize_input
from edm_tts_tpu_torch.ops.kmeans import assign


class SemanticTokenizerHubert(nn.Module):
    def __init__(self, config: HubertConfig | None = None, output_layer: int = 18,
                 num_clusters: int = 1024, *, device=None, dtype=None):
        super().__init__()
        self.config = config or HubertConfig()
        self.output_layer = min(output_layer, self.config.num_hidden_layers)
        self.hubert = HubertModel(self.config, device=device, dtype=dtype)
        self.register_buffer("cluster_centers", torch.zeros(
            num_clusters, self.config.hidden_size, device=device, dtype=torch.float32))
        self.sample_rate = 16000

    @property
    def downsample_factor(self) -> int:
        return self.config.downsample_factor

    @property
    def dtype(self) -> torch.dtype:
        return self.hubert.feature_projection.projection.weight.dtype

    def features(self, audio: torch.Tensor, attention_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(B, T)`` raw waveform -> the transformer's input and the frame
        mask (``HubertModel.features`` on the normalized waveform)."""
        return self.hubert.features(normalize_input(audio, attention_mask), attention_mask)

    def states(self, x: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
        """``features``' output -> layer-``output_layer`` states ``(B, T', H)``."""
        return self.hubert.run_layers(x, frame_mask, output_layer=self.output_layer)

    def ids(self, states: torch.Tensor) -> torch.Tensor:
        """States ``(B, T', H)`` -> ``(B, T')`` int64 nearest-centroid ids."""
        return assign(states, self.cluster_centers)[0]

    def hidden_states(self, audio: torch.Tensor,
                      attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, T)`` raw waveform -> layer-``output_layer`` states ``(B, T', H)``."""
        return self.states(*self.features(audio, attention_mask))

    def encode(self, audio: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, T)`` raw waveform -> ``(B, T // 320)`` int64 semantic ids."""
        return self.ids(self.hidden_states(audio, attention_mask))
