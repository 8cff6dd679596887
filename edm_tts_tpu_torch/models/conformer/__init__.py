from edm_tts_tpu_torch.models.conformer.conformer import (
    Attention,
    ChanLayerNorm,
    Conformer,
    ConformerBlock,
    ConformerConfig,
    ConvModule,
    FeedForward,
)

__all__ = [
    "Attention", "ChanLayerNorm", "Conformer", "ConformerBlock",
    "ConformerConfig", "ConvModule", "FeedForward",
]
