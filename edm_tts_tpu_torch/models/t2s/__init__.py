from edm_tts_tpu_torch.models.t2s.config import SPECIAL_TOKENS, T2SConfig
from edm_tts_tpu_torch.models.t2s.model import TextToSemantic
from edm_tts_tpu_torch.models.t2s.sampler import build_canvas, t2s_sample

__all__ = ["SPECIAL_TOKENS", "T2SConfig", "TextToSemantic", "build_canvas", "t2s_sample"]
