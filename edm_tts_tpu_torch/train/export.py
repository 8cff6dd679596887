"""Model directories a training run publishes (``save_s2a`` and
``save_t2s`` of edm_tts_tpu/utils/hub.py) and reads back.

A directory holds ``config.json`` and ``pytorch_model.bin``: the model's
state dict under the reference's key names (the codec's weight-norm pairs
as ``weight_v`` / ``weight_g``), CPU tensors. (``safetensors`` is not installed
on the card's machine; ``torch.save`` is.) Reading goes through
``utils.hub``, the port's one loader, which also reads the reference's
``model.safetensors`` directories.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models.s2a import InjectionConformer
from edm_tts_tpu_torch.models.t2s import TextToSemantic
from edm_tts_tpu_torch.utils import hub
from edm_tts_tpu_torch.utils.hub import load_codec, load_s2a, load_t2s  # noqa: F401 (the loaders)

WEIGHTS_NAME = hub.TORCH_NAME


def save_pretrained(path: str, model: nn.Module, config_json: str,
                    state: dict | None = None) -> None:
    """``state`` (default ``model.state_dict()``; a tensor-parallel trainer's
    ``model_state()`` holds the whole tensors) with the config."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(config_json)
    state = model.state_dict() if state is None else state
    state = {k: v.detach().to("cpu", copy=True) for k, v in state.items()}
    torch.save(state, os.path.join(path, WEIGHTS_NAME))


def load_state(path: str, model: nn.Module) -> None:
    """Load ``path``'s weights (either format) into ``model``, strictly,
    then repacked for the codec's kernels."""
    load_reference_state_dict(model, hub.load_weights(path))


def save_s2a(path: str, model: InjectionConformer, state: dict | None = None) -> None:
    save_pretrained(path, model, model.cfg.to_json(), state)


def save_t2s(path: str, model: TextToSemantic, state: dict | None = None) -> None:
    save_pretrained(path, model, model.cfg.to_json(), state)
