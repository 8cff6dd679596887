from edm_tts_tpu_torch.models.hubert.config import (
    HUBERT_LARGE_LL60K,
    HUBERT_TINY_TEST,
    HubertConfig,
)
from edm_tts_tpu_torch.models.hubert.convert import (
    hf_state_dict_from_jax_params,
    load_hf_state_dict,
)
from edm_tts_tpu_torch.models.hubert.model import HubertModel, normalize_input

__all__ = ["HUBERT_LARGE_LL60K", "HUBERT_TINY_TEST", "HubertConfig", "HubertModel",
           "hf_state_dict_from_jax_params", "load_hf_state_dict", "normalize_input"]
