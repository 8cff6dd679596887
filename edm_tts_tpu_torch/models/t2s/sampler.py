"""MaskGIT sampler of the text->semantic stage (port of
edm_tts_tpu/models/t2s/sampler.py), as an eager loop.

- canvas ``[TEXT] text [SEP] [SPEECH] <mask>*len [SEP]`` on a fixed
  ``max_speech_len`` grid; length from the length predictor
  (``ceil(exp(.))``) unless ``gt_length`` is given;
- ``pred_iters - 1`` sample + re-mask iterations; the final pass takes the
  argmax and overwrites the *whole* speech span;
- ``mask_len = max(1, min(floor(len * ratio), len))``; the re-mask gumbel
  is scaled by ``temperature * ratio``.

Randomness: per iteration two seeds from ``generator`` key the positional
draws of ops/masking.py. ``noise`` replaces them with pre-drawn gumbel
noise (the parity tests replay the JAX package's draws this way).
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.models.t2s.config import SPECIAL_TOKENS
from edm_tts_tpu_torch.models.t2s.model import TextToSemantic
from edm_tts_tpu_torch.ops import (
    positional_categorical,
    positional_gumbel,
    random_topk_mask,
    sampling_mask_ratios,
)


def build_canvas(text_tokens, text_lengths, speech_lengths, max_speech_len: int):
    """(canvas ``(B, L)``, attention ``(B, L)``, speech span ``(B, L)``) with
    ``L = Lt + 4 + max_speech_len``; text tokens are already +5."""
    b, lt = text_tokens.shape
    length = lt + 4 + max_speech_len
    pos = torch.arange(length, device=text_tokens.device)[None, :]
    tl = text_lengths[:, None]
    sl = speech_lengths[:, None]
    is_text = (pos >= 1) & (pos < 1 + tl)
    text_at_pos = torch.gather(text_tokens, 1, (pos - 1).clamp(0, lt - 1).expand(b, -1))
    speech_span = (pos >= 3 + tl) & (pos < 3 + tl + sl)

    canvas = torch.where(pos == 0, SPECIAL_TOKENS["text"], 0).expand(b, -1)
    canvas = torch.where(is_text, text_at_pos, canvas)
    canvas = torch.where(pos == 1 + tl, SPECIAL_TOKENS["sep"], canvas)
    canvas = torch.where(pos == 2 + tl, SPECIAL_TOKENS["speech"], canvas)
    canvas = torch.where(speech_span, SPECIAL_TOKENS["mask"], canvas)
    canvas = torch.where(pos == 3 + tl + sl, SPECIAL_TOKENS["sep"], canvas)
    attention = (pos <= 3 + tl + sl).expand(b, -1)
    return canvas.long(), attention, speech_span


def _seeds(generator: torch.Generator | None, n: int) -> list[int]:
    return torch.randint(0, 2**31 - 1, (n,), generator=generator).tolist()


@torch.no_grad()
def t2s_sample(
    model: TextToSemantic,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    pred_iters: int = 16,
    temperature: float = 1.0,
    max_speech_len: int = 1250,
    gt_length: torch.Tensor | None = None,
    greedy: bool = False,
    noise: dict[str, torch.Tensor] | None = None,
    row_offset: int = 0,
) -> dict[str, torch.Tensor]:
    """Batched text->semantic generation.

    Args:
      text_tokens: ``(B, Lt)`` byte tokens + 5; ``text_lengths``: ``(B,)``.
      gt_length: optional ``(B,)`` speech lengths (skips the predictor).
      greedy: argmax instead of categorical draws (re-masking still uses
        the gumbel noise, scaled by ``temperature``).
      noise: optional pre-drawn gumbel noise, ``"sample"``
        ``(pred_iters-1, B, L, V_sem)`` and ``"mask"`` ``(pred_iters-1, B, L)``.
      row_offset: the index of the first row in a larger batch (an engine
        replica's part), so the positional draws are that batch's.
    Returns ``semantic_tokens`` ``(B, max_speech_len)`` in [0, V_sem),
    ``lengths`` ``(B,)`` and ``valid`` ``(B, max_speech_len)``.
    """
    device = text_tokens.device
    cfg = model.cfg
    b, lt = text_tokens.shape
    offset = cfg.semantic_offset

    text_mask = torch.arange(lt, device=device)[None, :] < text_lengths[:, None]
    if gt_length is None:
        log_len = model.predict_log_length(text_tokens, text_mask, mask_conv=True)
        lengths = torch.ceil(torch.exp(log_len.float())).long()
    else:
        lengths = gt_length.long()
    lengths = lengths.clamp(1, max_speech_len)

    canvas, attention, speech_span = build_canvas(text_tokens, text_lengths, lengths,
                                                  max_speech_len)

    def logits_fn(tokens):
        return model.embeddings_to_logits(model.embed(tokens), attention,
                                          conv_pad_mask=attention)

    ratios = sampling_mask_ratios(pred_iters, device=device)
    init_num = lengths.float()
    tokens, mask = canvas, speech_span
    for i in range(pred_iters - 1):
        ratio = ratios[i]
        logits = logits_fn(tokens)
        if noise is None:
            seed_sample, seed_mask = _seeds(generator, 2)
        if greedy:
            sampled = torch.argmax(logits, dim=-1)
        elif noise is None:
            sampled = positional_categorical(seed_sample, logits, row_offset)
        else:
            sampled = torch.argmax(logits.float() + noise["sample"][i], dim=-1)

        mask_len = torch.floor(init_num * ratio)
        mask_len = torch.clamp(torch.minimum(mask_len, init_num), min=1.0)
        probs = torch.softmax(logits.float(), dim=-1)
        selected = torch.gather(probs, -1, sampled[..., None])[..., 0]
        selected = torch.where(mask, selected, torch.inf)
        gumbel = (noise["mask"][i] if noise is not None
                  else positional_gumbel(seed_mask, b, tokens.shape[1], device=device,
                                             row_offset=row_offset))
        next_mask = random_topk_mask(mask_len, selected, temperature=temperature * ratio,
                                     gumbel=gumbel)
        new_tokens = torch.where(next_mask, SPECIAL_TOKENS["mask"], sampled + offset)
        tokens = torch.where(speech_span, new_tokens, canvas)
        mask = next_mask

    final = torch.argmax(logits_fn(tokens), dim=-1)
    span_pos = 3 + text_lengths[:, None] + torch.arange(max_speech_len, device=device)[None, :]
    out = torch.gather(final, 1, span_pos.clamp(0, final.shape[1] - 1))
    valid = torch.arange(max_speech_len, device=device)[None, :] < lengths[:, None]
    return {
        "semantic_tokens": torch.where(valid, out, 0),
        "lengths": lengths,
        "valid": valid,
    }
