"""Serving: engine, dynamic batcher, long-form chunking and the HTTP server
(port of edm_tts_tpu/serving)."""

from edm_tts_tpu_torch.serving.batcher import DynamicBatcher, Request
from edm_tts_tpu_torch.serving.chunking import join_waveforms, split_text
from edm_tts_tpu_torch.serving.engine import TTSEngine
from edm_tts_tpu_torch.serving.server import TTSServer

__all__ = ["DynamicBatcher", "Request", "TTSEngine", "TTSServer", "join_waveforms", "split_text"]
