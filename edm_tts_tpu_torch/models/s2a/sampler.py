"""MaskGIT sampler of the semantic->acoustic stage (port of
edm_tts_tpu/models/s2a/sampler.py), as an eager loop.

``steps - 1`` level-0 sample + re-mask iterations through blocks 0..4, an
argmax pass, then one full 16-block pass with dynamic injection whose
argmax over every level gives the codes. The speaker prompt is
concatenated in front and never re-masked; its injections are its own
ground-truth codec features.

- schedule ``cos(pi/2 * (t+1)/steps)``; re-mask gumbel scaled by
  ``temperature * ratio``;
- ``mask_len = max(1, min(sum(mask) - 1, floor(n * ratio)))``;
- already-fixed positions carry ``+inf`` confidence.

Randomness: per iteration two seeds from ``generator`` key the positional
draws of ops/masking.py; ``noise`` replaces them with pre-drawn gumbel
noise for the parity tests.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.models.s2a.model import InjectionConformer
from edm_tts_tpu_torch.ops import (
    positional_categorical,
    positional_gumbel,
    random_topk_mask,
    sampling_mask_ratios,
)


@torch.no_grad()
def s2a_sample(
    model: InjectionConformer,
    semantic_tokens: torch.Tensor,
    acoustic_prompt_tokens: torch.Tensor | None,
    semantic_prompt_tokens: torch.Tensor | None,
    generator: torch.Generator | None = None,
    *,
    steps: int = 8,
    temperature: float = 1.0,
    semantic_valid: torch.Tensor | None = None,
    greedy: bool = False,
    noise: dict[str, torch.Tensor] | None = None,
    row_offset: int = 0,
) -> torch.Tensor:
    """Zero-shot semantic->acoustic generation.

    Args:
      semantic_tokens: ``(B, T)``.
      acoustic_prompt_tokens: ``(B, Q, Tp)`` prompt codes, or None.
      semantic_prompt_tokens: ``(B, Tp)`` prompt semantic tokens, or None.
      semantic_valid: optional bool ``(B, T)``, True at real positions: a
        padded canvas whose padding is kept out of attention, convs and the
        schedule (codes at padded positions are garbage).
      noise: optional pre-drawn gumbel noise, ``"sample"``
        ``(steps-1, B, T, N)`` and ``"mask"`` ``(steps-1, B, T)``.
      row_offset: the index of the first row in a larger batch (an engine
        replica's part), so the positional draws are that batch's.
    Returns ``(B, Q, T)`` codes.
    """
    device = semantic_tokens.device
    b, t = semantic_tokens.shape
    sem = model.embed_semantic(semantic_tokens)
    enc_gen = sem + model.mask_token
    prompt_injections = mask_time = enc_prompt = None
    tp = 0

    if acoustic_prompt_tokens is not None and semantic_prompt_tokens is not None:
        tp = acoustic_prompt_tokens.shape[-1]
        ac_p = model.acoustic_features_unreduced(acoustic_prompt_tokens)  # (B, Q, Tp, D)
        enc_prompt = model.embed_semantic(semantic_prompt_tokens) + model.project_acoustic(ac_p[:, 0])
        n_inj = min(len(model.cfg.injection_layers), acoustic_prompt_tokens.shape[1])
        cum = torch.cumsum(ac_p, dim=1)
        zeros = cum.new_zeros((b, t, cum.shape[-1]))
        prompt_injections = torch.stack(
            [torch.cat([cum[:, i], zeros], dim=1) for i in range(n_inj)])  # (n, B, Tp+T, D)
        mask_time = torch.cat([torch.zeros((b, tp), dtype=torch.bool, device=device),
                               torch.ones((b, t), dtype=torch.bool, device=device)], dim=1)

    pad_mask = None
    if semantic_valid is not None:
        pad_mask = semantic_valid
        if tp:
            pad_mask = torch.cat(
                [torch.ones((b, tp), dtype=torch.bool, device=device), semantic_valid], dim=1)

    def full_input(enc_gen):
        return enc_gen if enc_prompt is None else torch.cat([enc_prompt, enc_gen], dim=1)

    def first_level_logits(enc_gen):
        return model.forward_first_level(full_input(enc_gen), pad_mask)[:, tp:]

    def commit(enc_gen, mask, ids):
        proj = model.project_acoustic(model.acoustic_features(ids[:, None, :]))
        return torch.where(mask[:, :, None], sem + proj, enc_gen)

    if steps > 1:
        ratios = sampling_mask_ratios(steps, device=device)
        if semantic_valid is None:
            init_num = torch.full((b,), float(t), device=device)
            mask = torch.ones((b, t), dtype=torch.bool, device=device)
        else:
            init_num = semantic_valid.sum(-1).float()
            mask = semantic_valid
        for i in range(steps - 1):
            ratio = ratios[i]
            logits = first_level_logits(enc_gen)  # (B, T, N)
            if noise is None:
                seed_sample, seed_mask = torch.randint(
                    0, 2**31 - 1, (2,), generator=generator).tolist()
            if greedy:
                sampled = torch.argmax(logits, dim=-1)
            elif noise is None:
                sampled = positional_categorical(seed_sample, logits, row_offset)
            else:
                sampled = torch.argmax(logits.float() + noise["sample"][i], dim=-1)
            enc_gen = commit(enc_gen, mask, sampled)

            mask_len = torch.floor(init_num * ratio)
            mask_len = torch.clamp(torch.minimum(mask.sum(-1).float() - 1.0, mask_len), min=1.0)
            probs = torch.softmax(logits.float(), dim=-1)
            selected = torch.gather(probs, -1, sampled[..., None])[..., 0]
            selected = torch.where(mask, selected, torch.inf)
            gumbel = (noise["mask"][i] if noise is not None
                      else positional_gumbel(seed_mask, b, t, device=device,
                                             row_offset=row_offset))
            mask = random_topk_mask(mask_len, selected, temperature=temperature * ratio,
                                    gumbel=gumbel)
            enc_gen = torch.where(mask[:, :, None], sem + model.mask_token, enc_gen)

        enc_gen = commit(enc_gen, mask, torch.argmax(first_level_logits(enc_gen), dim=-1))

    all_logits = model.forward_logits(
        full_input(enc_gen), prompt_injections=prompt_injections, mask_time=mask_time,
        pad_mask=pad_mask, generated_start=tp,
    )  # (B, Q, T, N)
    return torch.argmax(all_logits, dim=-1)
