from edm_tts_tpu_torch.models.codec.config import CodecConfig
from edm_tts_tpu_torch.models.codec.model import Codec, pad_audio_to_hop

__all__ = ["Codec", "CodecConfig", "pad_audio_to_hop"]
