"""Weight-only int8 quantization of the t2s and s2a models (port of
edm_tts_tpu/models/quantize.py).

Every layer at one of the JAX package's ``QDense`` sites whose shape passes
``quantizable_shape`` becomes a ``QLinear`` made from its weight; every
other layer stays float, as in the JAX package:

- each Conformer block: ``ff1``/``ff2`` (``net.0``, ``net.3``), ``to_q``,
  ``to_kv``, ``to_out`` and the pointwise convs ``conv.net.2``/``net.7``;
- t2s: the ``pred_transform`` dense and ``pred_head``, and the blocks of
  both the main encoder and the length predictor;
- s2a: ``encoder.fine_head``.

``length_pred_head``, the feature projections, the embeddings, the stacked
logits head and the codec stay float. The models are changed in place; the
config's ``quantize`` field records the mode.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from edm_tts_tpu_torch.models.s2a.model import InjectionConformer
from edm_tts_tpu_torch.models.t2s.model import TextToSemantic
from edm_tts_tpu_torch.ops.qdense import MODES, QLinear, quantizable_shape

BLOCK_SITES = (
    "ff1.fn.fn.net.0", "ff1.fn.fn.net.3", "attn.fn.to_q", "attn.fn.to_kv",
    "attn.fn.to_out", "conv.net.2", "conv.net.7", "ff2.fn.fn.net.0", "ff2.fn.fn.net.3",
)


def _quantize_sites(model: nn.Module, paths: list[str], mode: str) -> None:
    if mode not in ("none", *MODES):
        raise ValueError(f"unknown quantize mode: {mode!r}")
    if mode == "none":
        return
    for path in paths:
        parent_path, _, name = path.rpartition(".")
        parent = model.get_submodule(parent_path)
        layer = getattr(parent, name)
        n, k = layer.weight.shape[:2]  # nn.Linear (N, K) or a k=1 conv (N, K, 1)
        if quantizable_shape(k, n):
            setattr(parent, name, QLinear.from_weight(layer.weight.reshape(n, k), layer.bias, mode))


def _block_paths(prefix: str, depth: int) -> list[str]:
    return [f"{prefix}.{i}.{site}" for i in range(depth) for site in BLOCK_SITES]


def quantize_t2s(model: TextToSemantic, mode: str = "int8") -> TextToSemantic:
    """Quantize ``model``'s sites in place (``mode``: "none", "int8", "w8a8")."""
    cfg = model.cfg
    _quantize_sites(model, [
        *_block_paths("conformer.layers", cfg.main_encoder_num_layers),
        *_block_paths("length_predictor.layers", cfg.length_predictor_num_layers),
        "pred_transform.0", "pred_head",
    ], mode)
    model.cfg = dataclasses.replace(cfg, quantize=mode)
    return model


def quantize_s2a(model: InjectionConformer, mode: str = "int8") -> InjectionConformer:
    """Quantize ``model``'s sites in place (``mode``: "none", "int8", "w8a8")."""
    cfg = model.cfg
    _quantize_sites(model, [*_block_paths("encoder.layers", cfg.encoder_num_layers),
                            "encoder.fine_head.0"], mode)
    model.cfg = dataclasses.replace(cfg, quantize=mode)
    return model
