from edm_tts_tpu_torch.models.s2a.config import S2AConfig
from edm_tts_tpu_torch.models.s2a.model import InjectionConformer
from edm_tts_tpu_torch.models.s2a.sampler import s2a_sample

__all__ = ["InjectionConformer", "S2AConfig", "s2a_sample"]
