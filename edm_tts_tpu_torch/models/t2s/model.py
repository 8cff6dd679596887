"""Text->semantic Conformer with length prediction, inference side (port of
edm_tts_tpu/models/t2s/model.py).

Module names and buffers follow the reference checkpoint
(``input_embedding``, ``conformer.layers.*``, ``length_predictor.layers.*``,
``pred_transform.{0,2}``, ``pred_head``, ``length_pred_head`` and the
token-id buffers), so its state dict loads strictly.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.conformer.conformer import LN_EPS, Conformer
from edm_tts_tpu_torch.models.t2s.config import SPECIAL_TOKENS, T2SConfig
from edm_tts_tpu_torch.ops import embed_take


class TextToSemantic(nn.Module):
    def __init__(self, cfg: T2SConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.input_embedding = nn.Embedding(cfg.total_num_tokens, h, **kw)
        self.length_token = nn.Parameter(torch.empty(1, 1, h, **kw))
        self.conformer = Conformer(cfg.main_encoder_config, **kw)
        self.length_predictor = Conformer(cfg.length_predictor_config, **kw)
        self.pred_transform = nn.Sequential(
            nn.Linear(h, h, **kw), nn.GELU(approximate="tanh"),
            nn.LayerNorm(h, eps=LN_EPS, **kw),
        )
        self.pred_head = nn.Linear(h, cfg.semantic_vocab_size, **kw)
        self.length_pred_head = nn.Linear(h, 1, **kw)
        for name in ("text", "speech", "sep", "pad", "mask"):
            self.register_buffer(f"{name}_token", torch.tensor([SPECIAL_TOKENS[name]], device=device))
        self.register_buffer("false", torch.tensor([False], device=device))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Joint-vocab ids -> embeddings; pad id 0 embeds to zeros."""
        e = embed_take(self.input_embedding.weight, tokens)
        return e * (tokens != SPECIAL_TOKENS["pad"])[..., None].to(e.dtype)

    def embeddings_to_logits(self, embeddings, attention_mask=None, *, conv_pad_mask=None):
        """``(B, L, H)`` -> semantic logits ``(B, L, V_sem)``."""
        out = self.conformer(embeddings, mask=attention_mask, conv_pad_mask=conv_pad_mask)
        return self.pred_head(self.pred_transform(out))

    def predict_log_length(self, text_ids, text_mask=None, *, mask_conv: bool = False):
        """[LEN] + text embeddings -> predicted log speech length ``(B,)``."""
        b = text_ids.shape[0]
        text_emb = self.embed(text_ids)
        inp = torch.cat([self.length_token.expand(b, 1, -1), text_emb], dim=1)
        mask = None
        if text_mask is not None:
            ones = torch.ones((b, 1), dtype=torch.bool, device=text_ids.device)
            mask = torch.cat([ones, text_mask.bool()], dim=1)
        out = self.length_predictor(inp, mask=mask, conv_pad_mask=mask if mask_conv else None)
        return self.length_pred_head(out[:, 0])[..., 0]
