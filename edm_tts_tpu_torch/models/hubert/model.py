"""HuBERT encoder, inference path (port of edm_tts_tpu/models/hubert/model.py).

The semantic tokens are the nearest k-means centroids of HuBERT-large's
layer-18 hidden states, so those states must match the reference's to
tolerance. Module and parameter names are HF ``transformers``' (an HF
``HubertModel`` state dict loads strictly through ``convert.
load_hf_state_dict``), so the weights need no renaming:

- conv feature extractor (``feature_extractor.conv_layers.{i}``): 7 convs
  (k/s 10/5, 3/2 x4, 2/2 x2) without padding, each followed by a LayerNorm
  over channels ("layer" mode; "group" mode: a GroupNorm after the first
  only) and exact GELU;
- feature projection: LayerNorm, then a linear to ``hidden_size``;
- conv positional embedding (``encoder.pos_conv_embed.conv``): k=128, pad
  64, 16 groups, the last frame dropped (SamePad of an even kernel), GELU;
  its weight is the effective one (the loader folds HF's weight norm);
- pre-LN transformer layers (``encoder.layers.{i}``), exact GELU; every
  layer is built so that a checkpoint loads strictly, but only the first
  ``output_layer`` run, and then without the final ``encoder.layer_norm``
  (HF's ``hidden_states[output_layer]``).

Activations are channel-last ``(B, T, H)``; the model runs in the dtype it
was built in. Attention goes through ``ops.attention.mha`` with the key
mask as a bool ``(B, T')`` mask: kernel K3 on the card, which takes bf16
only, the plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from edm_tts_tpu_torch.models.hubert.config import HubertConfig
from edm_tts_tpu_torch.ops.attention import mha


class HubertConvLayer(nn.Module):
    def __init__(self, cfg: HubertConfig, i: int, cin: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = cfg.conv_dim[i]
        self.conv = nn.Conv1d(cin, dim, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                              bias=cfg.conv_bias, **kw)
        self.norm = None
        if cfg.feat_extract_norm == "layer":
            self.norm = "layer"
            self.layer_norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps, **kw)
        elif cfg.feat_extract_norm == "group" and i == 0:
            self.norm = "group"
            self.layer_norm = nn.GroupNorm(dim, dim, eps=cfg.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C_in, T)`` -> ``(B, C, T')``."""
        x = self.conv(x)
        if self.norm == "layer":
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.norm == "group":
            x = self.layer_norm(x)
        return F.gelu(x)


class HubertFeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        cins = (1, *cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            HubertConvLayer(cfg, i, cin, device=device, dtype=dtype) for i, cin in enumerate(cins))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """``(B, T)`` waveform -> ``(B, T', conv_dim[-1])`` features."""
        x = audio[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class HubertFeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm = (nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps, **kw)
                           if cfg.feat_proj_layer_norm else None)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return self.projection(x)


class HubertPositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        k, h = cfg.num_conv_pos_embeddings, cfg.hidden_size
        self.conv = nn.Conv1d(h, h, k, padding=k // 2, groups=cfg.num_conv_pos_embedding_groups,
                              device=device, dtype=dtype)
        self.drop_last = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, H)`` -> ``(B, T, H)``."""
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:  # SamePad: an even kernel gives one frame too many
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class HubertAttention(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(h, h, **kw) for _ in range(4))

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        b, t, h = x.shape
        # HF scales q by d_head^-0.5 before the scores; mha applies that scale
        # itself. HF's additive finfo.min key bias is the bool mask here.
        q, k, v = (p(x).reshape(b, t, self.heads, h // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(mha(q, k, v, mask=key_mask).reshape(b, t, h))


class HubertFeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class HubertEncoderLayer(nn.Module):
    """Pre-LN (stable layer norm) transformer layer."""

    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = HubertAttention(cfg, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.feed_forward = HubertFeedForward(cfg, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attention(self.layer_norm(x), key_mask)
        return x + self.feed_forward(self.final_layer_norm(x))


class HubertEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.pos_conv_embed = HubertPositionalConvEmbedding(cfg, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(HubertEncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))


class HubertModel(nn.Module):
    def __init__(self, cfg: HubertConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.feature_extractor = HubertFeatureExtractor(cfg, **kw)
        self.feature_projection = HubertFeatureProjection(cfg, **kw)
        self.encoder = HubertEncoder(cfg, **kw)

    def features(self, input_values: torch.Tensor,
                 attention_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The transformer's input: the conv stack, the projection, padded
        frames zeroed and the positional embedding added; with the frame mask
        ``(B, T')`` (None without ``attention_mask``)."""
        x = self.feature_projection(self.feature_extractor(
            input_values.to(self.feature_projection.projection.weight.dtype)))
        frame_mask = None
        if attention_mask is not None:
            lengths = self.cfg.feature_lengths(attention_mask.long().sum(-1))
            frame_mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
            x = x * frame_mask[..., None].to(x.dtype)
        return x + self.encoder.pos_conv_embed(x), frame_mask

    def forward(self, input_values: torch.Tensor, attention_mask: torch.Tensor | None = None,
                *, output_layer: int | None = None) -> torch.Tensor:
        """``(B, T)`` waveform -> hidden states ``(B, T', H)`` after
        ``output_layer`` layers (HF's ``hidden_states[output_layer]``), or
        after all of them and the final LayerNorm when it is None.
        ``attention_mask`` ``(B, T)``: 1 on the valid samples."""
        return self.run_layers(*self.features(input_values, attention_mask),
                               output_layer=output_layer)

    def run_layers(self, x: torch.Tensor, frame_mask: torch.Tensor | None, *,
                   output_layer: int | None = None) -> torch.Tensor:
        """The transformer on ``features``' output: ``output_layer`` layers,
        or all of them and the final LayerNorm when it is None."""
        layers = self.encoder.layers if output_layer is None else self.encoder.layers[:output_layer]
        for layer in layers:
            x = layer(x, frame_mask)
        if output_layer is None:
            x = self.encoder.layer_norm(x)
        return x


def normalize_input(audio: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-utterance zero mean, unit variance in f32 (HF's
    ``Wav2Vec2FeatureExtractor(do_normalize=True)``, eps 1e-7); with
    ``attention_mask`` the statistics are over the valid samples and the
    padding is zeroed first."""
    audio = audio.float()
    if attention_mask is None:
        mean = audio.mean(-1, keepdim=True)
        var = audio.var(-1, unbiased=False, keepdim=True)
    else:
        m = attention_mask.float()
        n = m.sum(-1, keepdim=True)
        mean = (audio * m).sum(-1, keepdim=True) / n
        var = ((audio - mean) ** 2 * m).sum(-1, keepdim=True) / n
        audio = audio * m
    return (audio - mean) / torch.sqrt(var + 1e-7)
