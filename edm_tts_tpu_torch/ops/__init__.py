"""Tensor ops of the port (counterparts of edm_tts_tpu/ops)."""

from edm_tts_tpu_torch.ops.attention import (
    attention_lse_reference,
    flash_mha,
    flash_mha_bwd,
    flash_mha_bwd_reference,
    mha,
    mha_reference,
)
from edm_tts_tpu_torch.ops.convolution import conv1d, conv_transpose1d, weight_norm
from edm_tts_tpu_torch.ops.decoder_block import (
    decoder_block_reference,
    fused_decoder_block,
)
from edm_tts_tpu_torch.ops.embedding import embed_take, masked_cross_entropy
from edm_tts_tpu_torch.ops.masking import (
    cosine_schedule_mask,
    masked_mean,
    positional_categorical,
    positional_gumbel,
    random_topk_mask,
    sampling_mask_ratios,
)
from edm_tts_tpu_torch.ops.qdense import (
    QLinear,
    int8_dense,
    int8_dense_reference,
    quantizable_shape,
    quantize_weight,
)
from edm_tts_tpu_torch.ops.resunit import fused_residual_unit, resunit_reference
from edm_tts_tpu_torch.ops.rope import apply_rope, rope_frequencies, rotate_half
from edm_tts_tpu_torch.ops.snake import cos_fast, snake

__all__ = [
    "QLinear", "apply_rope", "attention_lse_reference", "conv1d",
    "conv_transpose1d", "cos_fast", "cosine_schedule_mask", "decoder_block_reference",
    "embed_take", "flash_mha", "flash_mha_bwd", "flash_mha_bwd_reference",
    "fused_decoder_block", "fused_residual_unit", "int8_dense", "int8_dense_reference",
    "masked_cross_entropy", "masked_mean", "mha", "mha_reference", "positional_categorical",
    "positional_gumbel", "quantizable_shape", "quantize_weight", "random_topk_mask",
    "resunit_reference", "rope_frequencies", "rotate_half", "sampling_mask_ratios", "snake",
    "weight_norm",
]
