"""HuBERT weights for the port, in HF ``transformers``' format (the
reference's, e.g. ``facebook/hubert-large-ll60k``).

``load_hf_state_dict`` loads an HF ``HubertModel`` state dict into the
port's ``HubertModel`` strictly: every key is used and every parameter is
filled. Two keys differ from a plain ``load_state_dict``:

- the positional conv's weight-norm pair is folded into its effective
  weight. HF applies ``weight_norm(dim=2)`` there: ``g`` is ``(1, 1, K)``
  and the norm runs over (out, in) for each tap, not over every dim but the
  first as the codec's pairs (``edm_tts_tpu_torch.convert.fold_weight_norm``)
  do. ``fold_pos_conv`` folds it per tap;
- ``masked_spec_embed`` (the vector SpecAugment writes over masked frames in
  training; HF keeps it when a mask probability is set) is not used by
  inference and is dropped.

``hf_state_dict_from_jax_params`` goes the other way from the JAX package:
it turns that package's HuBERT parameters (nested numpy arrays, as its
``from_hf_state_dict`` makes them) back into an HF state dict, so one set of
weights can be fed to both packages. It does not import the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from edm_tts_tpu_torch.models.hubert.config import HubertConfig
from edm_tts_tpu_torch.models.hubert.model import HubertModel

POS_CONV = "encoder.pos_conv_embed.conv"
# both torch weight-norm spellings: the legacy hook's and parametrize's
_POS_CONV_PAIRS = ((f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v"),
                   (f"{POS_CONV}.parametrizations.weight.original0",
                    f"{POS_CONV}.parametrizations.weight.original1"))
TRAINING_ONLY = ("masked_spec_embed",)


def fold_pos_conv(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``weight_norm(dim=2)``'s effective weight: ``g * v / ||v||`` with the
    norm over (out, in) of each tap; ``v`` ``(out, in/groups, K)``, ``g``
    ``(1, 1, K)``."""
    return v * (g / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True)))


def load_hf_state_dict(model: HubertModel, sd: Mapping[str, object]) -> None:
    """Load an HF ``HubertModel`` state dict (tensors or arrays) strictly."""
    sd = {k: torch.as_tensor(np.array(v, dtype=np.float32)) for k, v in sd.items()
          if k not in TRAINING_ONLY}
    for g_key, v_key in _POS_CONV_PAIRS:
        if g_key in sd or v_key in sd:
            sd[f"{POS_CONV}.weight"] = fold_pos_conv(sd.pop(g_key), sd.pop(v_key))
    own = model.state_dict()
    for key, t in sd.items():
        if key in own and tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model shape {tuple(own[key].shape)}")
    model.load_state_dict(sd, strict=True)


def hf_state_dict_from_jax_params(cfg: HubertConfig, params: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's HuBERT parameters -> an HF state dict (numpy f32).

    Inverts that package's ``from_hf_state_dict``: Dense kernels ``(in,
    out)`` become ``(out, in)`` weights, conv kernels ``(K, in, out)``
    become ``(out, in, K)``. Its positional conv holds the folded weight
    ``w``; it comes back as the pair ``v = w``, ``g = ||w||`` per tap, which
    folds to ``w``.
    """
    p = params.get("params", params)

    def a(x) -> np.ndarray:
        return np.array(x, dtype=np.float32)

    sd: dict[str, np.ndarray] = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = a(fe[f"conv_{i}_kernel"]).transpose(2, 1, 0)
        if cfg.conv_bias:
            sd[f"{base}.conv.bias"] = a(fe[f"conv_{i}_bias"])
        norm = (fe.get(f"layer_norm_{i}") if cfg.feat_extract_norm == "layer"
                else fe.get("group_norm") if i == 0 else None)
        if norm is not None:
            sd[f"{base}.layer_norm.weight"] = a(norm["scale"])
            sd[f"{base}.layer_norm.bias"] = a(norm["bias"])
    if cfg.feat_proj_layer_norm:
        sd["feature_projection.layer_norm.weight"] = a(p["feat_proj_layer_norm"]["scale"])
        sd["feature_projection.layer_norm.bias"] = a(p["feat_proj_layer_norm"]["bias"])
    sd["feature_projection.projection.weight"] = a(p["feat_proj"]["kernel"]).T
    sd["feature_projection.projection.bias"] = a(p["feat_proj"]["bias"])

    w = a(p["pos_conv"]["kernel"]).transpose(2, 1, 0)  # (out, in/groups, K)
    sd[f"{POS_CONV}.parametrizations.weight.original0"] = np.sqrt(
        np.sum(w ** 2, axis=(0, 1), keepdims=True))
    sd[f"{POS_CONV}.parametrizations.weight.original1"] = w
    sd[f"{POS_CONV}.bias"] = a(p["pos_conv"]["bias"])

    dense = {"attention.q_proj": "q_proj", "attention.k_proj": "k_proj",
             "attention.v_proj": "v_proj", "attention.out_proj": "out_proj",
             "feed_forward.intermediate_dense": "fc1", "feed_forward.output_dense": "fc2"}
    for i in range(cfg.num_hidden_layers):
        layer, base = p[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("layer_norm", "final_layer_norm"):
            sd[f"{base}.{name}.weight"] = a(layer[name]["scale"])
            sd[f"{base}.{name}.bias"] = a(layer[name]["bias"])
        for hf, jx in dense.items():
            sd[f"{base}.{hf}.weight"] = a(layer[jx]["kernel"]).T
            sd[f"{base}.{hf}.bias"] = a(layer[jx]["bias"])
    sd["encoder.layer_norm.weight"] = a(p["encoder_layer_norm"]["scale"])
    sd["encoder.layer_norm.bias"] = a(p["encoder_layer_norm"]["bias"])
    return sd
