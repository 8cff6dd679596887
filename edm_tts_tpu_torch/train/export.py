"""Model directories a training run publishes (``save_s2a`` of
edm_tts_tpu/utils/hub.py) and reads back.

A directory holds ``config.json`` and ``pytorch_model.bin``: the model's
state dict under the reference's key names (weight-norm pairs already
folded into ``.weight``), CPU tensors, loaded back strictly by
``convert.load_reference_state_dict``. (``safetensors`` is not installed
on the card's machine; ``torch.save`` is.)
"""

from __future__ import annotations

import os

import torch
from torch import nn

from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig

WEIGHTS_NAME = "pytorch_model.bin"


def save_pretrained(path: str, model: nn.Module, config_json: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config_json)
    state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, WEIGHTS_NAME))


def load_state(path: str, model: nn.Module) -> None:
    """Load ``path``'s weights into ``model`` (strictly, then repacked for
    the decoder's kernels)."""
    state = torch.load(os.path.join(path, WEIGHTS_NAME), map_location="cpu", weights_only=True)
    load_reference_state_dict(model, {k: v.numpy() for k, v in state.items()})


def save_s2a(path: str, model: InjectionConformer) -> None:
    save_pretrained(path, model, model.cfg.to_json())


def load_s2a(path: str, *, device="cuda", dtype=torch.float32) -> InjectionConformer:
    model = InjectionConformer(S2AConfig.load(path), device=device, dtype=dtype)
    load_state(path, model)
    return model


def load_codec(path: str, *, device="cuda", dtype=torch.float32) -> Codec:
    codec = Codec(CodecConfig.load(path), device=device, dtype=dtype)
    load_state(path, codec)
    return codec
