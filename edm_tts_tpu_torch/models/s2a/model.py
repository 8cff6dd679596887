"""Semantic->acoustic injection Conformer (port of
edm_tts_tpu/models/s2a/model.py): inference and the masked-LM training
forward.

Sixteen Conformer blocks predict all 12 RVQ levels; at the injection
layers (4, 7, 10, 13) the coarse levels decoded so far are turned back into
codec features and injected (dynamic injection): argmax of the stacked
coarse logits -> codec ``codes_to_features`` (f32) -> ``FeatProj`` -> add,
plus the previous coarse output as a residual. Prompt positions take the
prompt's ground-truth features instead (a ``where`` on ``mask_time``).

Training (``forward_train``) masks a cosine-schedule share of the
positions, feeds the teacher's cumulative codec features at the injection
layers and takes the cross-entropy of all 12 levels on the masked
positions.

Module names follow the reference checkpoint: the frozen codec is
``acoustic_model``, the blocks ``encoder.layers.*``, the heads
``encoder.fine_head.0`` and ``encoder.to_logits.{0,1}``.
"""

from __future__ import annotations

import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.model import Codec
from edm_tts_tpu_torch.models.conformer.conformer import LN_EPS, ConformerBlock, apply_block
from edm_tts_tpu_torch.models.s2a.config import S2AConfig
from edm_tts_tpu_torch.ops import (
    cosine_schedule_mask,
    embed_take,
    masked_cross_entropy,
    rope_frequencies,
)


def _feat_proj(d_in: int, d_out: int, **kw) -> nn.Sequential:
    """Linear + LayerNorm feature projection."""
    return nn.Sequential(nn.Linear(d_in, d_out, **kw), nn.LayerNorm(d_out, eps=LN_EPS, **kw))


class _StackedLogits(nn.Module):
    """The reference's per-level EinMix head: ``weight`` ``(Q, H, N)``,
    ``bias`` ``(1, 1, Q, N)``."""

    def __init__(self, q: int, h: int, n: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(q, h, n, **kw))
        self.bias = nn.Parameter(torch.zeros(1, 1, q, n, **kw))


class _Encoder(nn.Module):
    def __init__(self, cfg: S2AConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        self.layers = nn.ModuleList(
            ConformerBlock(cfg.encoder_config, **kw) for _ in range(cfg.encoder_num_layers))
        self.project_injection = nn.ModuleList(
            _feat_proj(cfg.codec.latent_dim, h, **kw) for _ in cfg.injection_layers)
        remaining = cfg.num_quantizers - len(cfg.injection_layers)
        self.fine_head = nn.Sequential(nn.Linear(h, h * remaining, **kw))
        self.to_logits = nn.ModuleList([
            nn.LayerNorm(h, eps=LN_EPS, **kw),
            _StackedLogits(cfg.num_quantizers, h, cfg.num_codevectors, **kw),
        ])


class InjectionConformer(nn.Module):
    def __init__(self, cfg: S2AConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.acoustic_model = Codec(cfg.codec, **kw)
        self.semantic_embedding = nn.Embedding(cfg.num_semantic_tokens, h, **kw)
        self.mask_token = nn.Parameter(torch.empty(1, 1, h, **kw))
        self.acoustic_feat_proj = _feat_proj(cfg.codec.latent_dim, h, **kw)
        self.encoder = _Encoder(cfg, **kw)
        self.remaining_quantizers = cfg.num_quantizers - len(cfg.injection_layers)

    # -- heads ---------------------------------------------------------------
    def to_logits(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, Q, H)`` -> ``(B, Q, T, N)``."""
        norm, head = self.encoder.to_logits
        q, n = head.weight.shape[0], head.weight.shape[2]
        return (torch.einsum("btqh,qhn->bqtn", norm(x), head.weight)
                + head.bias.reshape(q, n)[None, :, None, :])

    def single_level_logits(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """``(B, T, H)`` -> ``(B, T, N)`` for one quantizer level."""
        norm, head = self.encoder.to_logits
        return norm(x) @ head.weight[level] + head.bias[0, 0, level]

    # -- embedding helpers ---------------------------------------------------
    def embed_semantic(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_take(self.semantic_embedding.weight, tokens)

    def project_acoustic(self, features: torch.Tensor) -> torch.Tensor:
        return self.acoustic_feat_proj(features.to(self.dtype))

    def acoustic_features_unreduced(self, codes: torch.Tensor) -> torch.Tensor:
        return self.acoustic_model.codes_to_features_unreduced(codes)

    def acoustic_features(self, codes: torch.Tensor) -> torch.Tensor:
        return self.acoustic_model.codes_to_features(codes)

    def decode_audio(self, codes: torch.Tensor) -> torch.Tensor:
        return self.acoustic_model.decode_from_codes(codes)

    # -- forward passes ------------------------------------------------------
    def forward_first_level(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None):
        """Blocks up to the first injection layer -> level-0 logits ``(B, L, N)``.

        ``pad_mask`` (bool ``(B, L)``, True = valid) masks attention keys and
        the conv modules, so padded positions do not reach valid ones."""
        rope = rope_frequencies(x.shape[-2], self.cfg.encoder_config.dim_head, device=x.device)
        for block in self.encoder.layers[: self.cfg.injection_layers[0] + 1]:
            x = block(x, rope=rope, mask=pad_mask, conv_pad_mask=pad_mask)
        return self.single_level_logits(x, 0)

    def forward_logits(
        self,
        x: torch.Tensor,
        *,
        prompt_injections: torch.Tensor | None = None,
        mask_time: torch.Tensor | None = None,
        pad_mask: torch.Tensor | None = None,
        generated_start: int = 0,
    ) -> torch.Tensor:
        """All 16 blocks with dynamic injection -> logits ``(B, Q, L', N)``,
        where L' drops the first ``generated_start`` (prompt) positions.

        ``prompt_injections`` ``(n_inj, B, L, D)`` replaces the injected
        features where ``mask_time`` (bool ``(B, L)``) is False."""
        cfg = self.cfg
        rope = rope_frequencies(x.shape[-2], cfg.encoder_config.dim_head, device=x.device)
        coarse_outputs: list[torch.Tensor] = []
        coarse_logits: list[torch.Tensor] = []
        for i, block in enumerate(self.encoder.layers):
            cur = block(x, rope=rope, mask=pad_mask, conv_pad_mask=pad_mask)
            if i in cfg.injection_layers:
                idx = cfg.injection_layers.index(i)
                residual = coarse_outputs[-1] if (coarse_outputs and cfg.residual) else 0.0
                coarse_outputs.append(cur)
                if cfg.use_injection:
                    coarse_logits.append(self.single_level_logits(cur, idx))
                    tokens = torch.argmax(torch.stack(coarse_logits, dim=1), dim=-1)
                    injection = self.acoustic_features(tokens)
                    if prompt_injections is not None:
                        injection = torch.where(mask_time[:, :, None], injection,
                                                prompt_injections[idx])
                    cur = cur + self.encoder.project_injection[idx](injection.to(self.dtype)) + residual
                else:
                    cur = cur + residual
            x = cur
        final, coarse = x, coarse_outputs
        if generated_start:
            final = final[:, generated_start:]
            coarse = [c[:, generated_start:] for c in coarse]
        return self._all_level_logits(final, coarse)

    def _all_level_logits(self, final: torch.Tensor, coarse: list[torch.Tensor]) -> torch.Tensor:
        """Coarse outputs and the fine head of ``final`` -> ``(B, Q, T, N)``."""
        b, t, h = final.shape
        fine = self.encoder.fine_head(final).reshape(b, t, self.remaining_quantizers, h)
        return self.to_logits(torch.cat([torch.stack(coarse, dim=2), fine], dim=2))

    # -- training ------------------------------------------------------------
    def forward_teacher_logits(
        self, x: torch.Tensor, teacher: torch.Tensor, *, dropout_generator=None
    ) -> torch.Tensor:
        """All 16 blocks with teacher injection -> logits ``(B, Q, T, N)``.

        ``teacher`` ``(n_inj, B, T, D)``: the codec features injected after
        each injection layer (the JAX ``_run_stack`` with
        ``teacher_injections``). With ``gradient_checkpointing`` each block
        is checkpointed under ``remat_policy`` while autograd records."""
        cfg = self.cfg
        rope = rope_frequencies(x.shape[-2], cfg.encoder_config.dim_head, device=x.device)
        coarse: list[torch.Tensor] = []
        for i, block in enumerate(self.encoder.layers):
            cur = apply_block(block, x, cfg.encoder_config, rope=rope,
                              dropout_generator=dropout_generator)
            if i in cfg.injection_layers:
                idx = cfg.injection_layers.index(i)
                residual = coarse[-1] if (coarse and cfg.residual) else 0.0
                coarse.append(cur)
                if cfg.use_injection:
                    cur = cur + self.encoder.project_injection[idx](teacher[idx].to(self.dtype))
                cur = cur + residual
            x = cur
        return self._all_level_logits(x, coarse)

    def forward_train(
        self,
        acoustic_tokens: torch.Tensor,
        semantic_tokens: torch.Tensor,
        *,
        generator: torch.Generator | None = None,
        mask_override: torch.Tensor | None = None,
        train: bool = True,
    ) -> dict[str, torch.Tensor]:
        """Masked-LM training forward (the JAX ``__call__``).

        ``acoustic_tokens`` int ``(B, Q, T)``, ``semantic_tokens`` int
        ``(B, T)``. The mask (bool ``(B, T)``, True = masked) is drawn from
        ``generator`` unless ``mask_override`` gives it; with ``train`` the
        dropout masks come from ``generator`` too. Returns ``loss`` (f32
        scalar), ``mask`` and ``n_masked``, the masked-position count that
        weights micro-batched gradient accumulation.
        """
        cfg = self.cfg
        b, t = semantic_tokens.shape
        if mask_override is not None:
            mask = mask_override
        else:
            mask = cosine_schedule_mask(generator, b, t, device=semantic_tokens.device)
        enc_in, teacher = prepare_train_inputs(self, acoustic_tokens, semantic_tokens, mask)
        logits = self.forward_teacher_logits(
            enc_in, teacher, dropout_generator=generator if train else None)
        loss = masked_cross_entropy(logits, *train_targets(cfg, acoustic_tokens, mask))
        return {"loss": loss, "mask": mask, "n_masked": mask.sum()}


# -- the training forward's ends, shared with the pipelined forward
# (models/s2a/pipeline.py) so that the two cannot drift --------------------
def prepare_train_inputs(model: InjectionConformer, acoustic_tokens: torch.Tensor,
                         semantic_tokens: torch.Tensor,
                         mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked encoder input ``(B, T, H)`` and the teacher's cumulative
    codec features ``(Qc, B, T, D)`` (the frozen codec runs without
    gradient)."""
    sem = model.embed_semantic(semantic_tokens)
    with torch.no_grad():
        ac_unred = model.acoustic_features_unreduced(acoustic_tokens)  # (B, Q, T, D)
    ac0 = model.project_acoustic(ac_unred[:, 0])
    enc_in = torch.where(mask[:, :, None], sem + model.mask_token, sem + ac0)
    n_inj = len(model.cfg.injection_layers)
    teacher = torch.cumsum(ac_unred, dim=1)[:, :n_inj].transpose(0, 1)
    return enc_in, teacher


def train_targets(cfg: S2AConfig, acoustic_tokens: torch.Tensor,
                  mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The labels ``(B, Q, T)`` and the positions the loss counts: every one
    with ``loss_all``, else the masked ones."""
    targets = acoustic_tokens.long()
    loss_mask = (torch.ones_like(targets, dtype=torch.bool) if cfg.loss_all
                 else mask[:, None, :].expand(targets.shape))
    return targets, loss_mask
