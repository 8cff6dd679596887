"""End-to-end synthesis: text + speaker-prompt codes -> 16 kHz waveform.

Port of edm_tts_tpu/pipeline.py::e2e_synthesize, run eagerly: the t2s
MaskGIT sampler, the s2a sampler with dynamic injection, then codec decode
of the whole ``max_speech_len`` canvas. On the card attention runs as
kernel K3 and the decoder as kernels K1 and K2.
"""

from __future__ import annotations

import torch

from edm_tts_tpu_torch.models.s2a import InjectionConformer, s2a_sample
from edm_tts_tpu_torch.models.t2s import TextToSemantic, t2s_sample


@torch.no_grad()
def e2e_synthesize(
    t2s_model: TextToSemantic,
    s2a_model: InjectionConformer,
    text_tokens: torch.Tensor,
    text_lengths: torch.Tensor,
    prompt_acoustic: torch.Tensor,
    prompt_semantic: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    pred_iters: int = 16,
    steps: int = 8,
    temperature: float = 1.0,
    max_speech_len: int = 1250,
    gt_length: torch.Tensor | None = None,
    assume_full_canvas: bool = False,
    greedy: bool = False,
) -> dict[str, torch.Tensor]:
    """Full zero-shot TTS.

    Args:
      text_tokens: ``(B, Lt)`` byte tokens + 5; ``text_lengths``: ``(B,)``.
      prompt_acoustic: ``(1 or B, Q, Tp)`` speaker prompt codes.
      prompt_semantic: ``(1 or B, Tp)`` speaker prompt semantic tokens.
      gt_length: optional ``(B,)`` speech lengths (skips length prediction).
      assume_full_canvas: every row fills ``max_speech_len``; skips the
        padding masks in the s2a stage.
      greedy: both samplers take the argmax (re-masking keeps its noise).
    Returns ``audio`` ``(B, decoded_length(max_speech_len), 1)``, ``lengths``
    ``(B,)`` (valid samples = lengths * hop), ``semantic_tokens`` and
    ``acoustic_codes``.
    """
    b = text_tokens.shape[0]
    t2s_out = t2s_sample(
        t2s_model, text_tokens, text_lengths, generator, pred_iters=pred_iters,
        temperature=temperature, max_speech_len=max_speech_len, gt_length=gt_length,
        greedy=greedy,
    )
    valid = None if assume_full_canvas else t2s_out["valid"]
    codes = s2a_sample(
        s2a_model, t2s_out["semantic_tokens"],
        prompt_acoustic.expand(b, *prompt_acoustic.shape[1:]),
        prompt_semantic.expand(b, *prompt_semantic.shape[1:]),
        generator, steps=steps, temperature=temperature, semantic_valid=valid,
        greedy=greedy,
    )
    return {
        "audio": s2a_model.decode_audio(codes),
        "lengths": t2s_out["lengths"],
        "semantic_tokens": t2s_out["semantic_tokens"],
        "acoustic_codes": codes,
    }
