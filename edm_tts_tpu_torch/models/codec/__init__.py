from edm_tts_tpu_torch.models.codec.config import CodecConfig
from edm_tts_tpu_torch.models.codec.model import Codec

__all__ = ["Codec", "CodecConfig"]
