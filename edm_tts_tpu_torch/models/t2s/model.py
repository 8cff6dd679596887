"""Text->semantic Conformer with length prediction (port of
edm_tts_tpu/models/t2s/model.py): inference and the masked-LM training
forward.

Module names and buffers follow the reference checkpoint
(``input_embedding``, ``conformer.layers.*``, ``length_predictor.layers.*``,
``pred_transform.{0,2}``, ``pred_head``, ``length_pred_head`` and the
token-id buffers), so its state dict loads strictly.

Training (``forward_train``) masks a cosine-schedule share of each speech
span with ``[MASK]``, takes the cross-entropy of the semantic tokens there
and the L1 error of the predicted log speech length. Both Conformers run
without ``conv_pad_mask`` in training, as in the JAX package: the
reference's unmasked depthwise conv on padded batches.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.conformer.conformer import LN_EPS, Conformer
from edm_tts_tpu_torch.models.t2s.config import SPECIAL_TOKENS, T2SConfig
from edm_tts_tpu_torch.ops import cosine_schedule_mask, embed_take, masked_cross_entropy


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

    def embeddings_to_logits(self, embeddings, attention_mask=None, *, conv_pad_mask=None,
                             dropout_generator=None):
        """``(B, L, H)`` -> semantic logits ``(B, L, V_sem)``."""
        out = self.conformer(embeddings, mask=attention_mask, conv_pad_mask=conv_pad_mask,
                             dropout_generator=dropout_generator)
        return self.pred_head(self.pred_transform(out))

    def extract_features(self, input_ids, attention_mask=None, output_layer_idx=None,
                         return_attn=False):
        """Main-encoder hidden states ``(B, L, H)`` of joint-vocab ids, to
        block ``output_layer_idx`` when given; with ``return_attn`` also the
        per-block attention maps (``Conformer.forward``)."""
        return self.conformer(self.embed(input_ids), mask=attention_mask,
                              output_layer_idx=output_layer_idx, return_attn=return_attn)

    def predict_log_length(self, text_ids, text_mask=None, *, mask_conv: bool = False,
                           dropout_generator=None):
        """[LEN] + text embeddings -> predicted log speech length ``(B,)``."""
        b = text_ids.shape[0]
        text_emb = self.embed(text_ids)
        inp = torch.cat([self.length_token.expand(b, 1, -1), text_emb], dim=1)
        mask = None
        if text_mask is not None:
            ones = torch.ones((b, 1), dtype=torch.bool, device=text_ids.device)
            mask = torch.cat([ones, text_mask.bool()], dim=1)
        out = self.length_predictor(inp, mask=mask, conv_pad_mask=mask if mask_conv else None,
                                    dropout_generator=dropout_generator)
        return self.length_pred_head(out[:, 0])[..., 0]

    def forward_train(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        speech_mask: torch.Tensor,
        text_ids: torch.Tensor,
        text_attention_mask: torch.Tensor,
        speech_lengths: torch.Tensor,
        *,
        generator: torch.Generator | None = None,
        mask_override: torch.Tensor | None = None,
        train: bool = True,
    ) -> dict[str, torch.Tensor]:
        """Masked-LM and length loss (the JAX ``__call__``), on the batch
        ``data.collators.collate_t2s`` makes.

        The mask (bool ``(B, L)``, True = masked) is a cosine-schedule draw
        from ``generator`` (one rate ``cos u``, ``u ~ U(0, pi/2)``, per
        sample), or ``mask_override``, ANDed with ``speech_mask``; with
        ``train`` the dropout masks come from ``generator`` too. Returns
        ``loss`` (= ``ce_loss + length_loss``, f32 scalars) and ``mask``.
        """
        cfg = self.cfg
        b, l = input_ids.shape
        if mask_override is None:
            mask_override = cosine_schedule_mask(generator, b, l, device=input_ids.device)
        mask = mask_override & speech_mask
        masked_input = torch.where(mask, SPECIAL_TOKENS["mask"], input_ids)
        drop = generator if train else None
        logits = self.embeddings_to_logits(self.embed(masked_input), attention_mask,
                                           dropout_generator=drop)
        targets = input_ids.long() - cfg.semantic_offset
        # the reference's CrossEntropyLoss(ignore_index=0) on the shifted
        # targets leaves semantic token 0 out of the loss; kept, as in JAX
        loss_mask = mask & (targets != 0)
        # every position is gathered: clip the text and special ids into range
        ce_loss = masked_cross_entropy(logits, targets.clamp(0, cfg.semantic_vocab_size - 1),
                                       loss_mask)
        length_pred = self.predict_log_length(text_ids, text_attention_mask,
                                              dropout_generator=drop)
        length_loss = (length_pred.float() - torch.log(speech_lengths.float())).abs().mean()
        return {"loss": ce_loss + length_loss, "ce_loss": ce_loss, "length_loss": length_loss,
                "mask": mask}
