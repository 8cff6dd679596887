from edm_tts_tpu_torch.models.tokenizer.audio_tokenizer import AudioTokenizer
from edm_tts_tpu_torch.models.tokenizer.semantic_hubert import SemanticTokenizerHubert

__all__ = ["AudioTokenizer", "SemanticTokenizerHubert"]
