"""Weights for the port's models: reference checkpoints and seeded random init.

``load_reference_state_dict`` takes a state dict in the reference
(``from_pretrained``) format as numpy arrays — what the JAX package's
``models/{codec,t2s,s2a}/convert.py::to_torch_state_dict`` emit — and loads
it strictly: every key is used and every parameter and buffer is filled.
The codec's weight-norm pairs, in either torch spelling, load as the
modules' ``weight_v`` / ``weight_g`` parameters, and each module keeps the
f32 fold of its pair as its inference kernel.

``init_random_weights`` fills a model from a seed, for runs that have no
checkpoint (the card's smoke run, a training run's start): same shapes and
scales as a fresh model, deterministic for a given seed and device.

Both end by laying the codec's weights out once as its kernels take them
(``Encoder.pack`` and ``Decoder.pack``). HuBERT's weights come in HF's
format through ``models.hubert.convert.load_hf_state_dict``.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from edm_tts_tpu_torch.models.codec.decoder import Decoder
from edm_tts_tpu_torch.models.codec.encoder import Encoder
from edm_tts_tpu_torch.models.codec.layers import (
    Snake,
    WeightNormed,
    fold_weight,
    norm_but_first,
)
from edm_tts_tpu_torch.models.conformer.conformer import ChanLayerNorm
from edm_tts_tpu_torch.models.s2a.model import InjectionConformer, _StackedLogits
from edm_tts_tpu_torch.models.t2s.model import TextToSemantic
from edm_tts_tpu_torch.ops import weight_norm

# both torch weight-norm spellings: the legacy hook's and parametrize's
_WN_PARTS = {
    ".weight_g": "g",
    ".weight_v": "v",
    ".parametrizations.weight.original0": "g",
    ".parametrizations.weight.original1": "v",
}


def _split_pairs(sd: Mapping[str, np.ndarray]):
    """``(other entries as tensors, {prefix: {"g": g, "v": v}})`` of ``sd``."""
    out: dict[str, torch.Tensor] = {}
    pairs: dict[str, dict[str, np.ndarray]] = {}
    for key, arr in sd.items():
        for suffix, part in _WN_PARTS.items():
            if key.endswith(suffix):
                pairs.setdefault(key[: -len(suffix)], {})[part] = arr
                break
        else:
            out[key] = torch.as_tensor(np.array(arr))
    for prefix, pair in pairs.items():
        if set(pair) != {"g", "v"}:
            raise KeyError(f"weight norm pair at {prefix!r} is incomplete: {sorted(pair)}")
    return out, pairs


def fold_weight_norm(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Replace each ``(g, v)`` pair by ``<prefix>.weight = g * v / ||v||``.

    torch's ``weight_norm(dim=0)`` takes the norm over every dim but the
    first, for Conv1d (per output channel), ConvTranspose1d (per *input*
    channel) and the RVQ's 1x1 projections alike.
    """
    out, pairs = _split_pairs(sd)
    for prefix, pair in pairs.items():
        v = torch.as_tensor(np.asarray(pair["v"], np.float32))
        g = torch.as_tensor(np.asarray(pair["g"], np.float32)).reshape(-1)
        out[f"{prefix}.weight"] = weight_norm(v.movedim(0, -1), g).movedim(-1, 0)
    return out


def weight_norm_tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``sd`` as tensors with each pair under the legacy names
    ``<prefix>.weight_v`` and ``<prefix>.weight_g`` (g shaped ``(C, 1, ...)``
    as ``weight_norm`` keeps it), whichever spelling it came in."""
    out, pairs = _split_pairs(sd)
    for prefix, pair in pairs.items():
        v = torch.as_tensor(np.array(pair["v"], np.float32))
        out[f"{prefix}.weight_v"] = v
        out[f"{prefix}.weight_g"] = torch.as_tensor(np.array(pair["g"], np.float32)).reshape(
            v.shape[0], *(1,) * (v.dim() - 1))
    return out


def load_reference_state_dict(module: nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """Load a reference-format numpy state dict into ``module``, strictly.

    A weight-normed module's folded ``<prefix>.weight`` (as the port's
    exports before trainable weight norm wrote it) loads as ``v = weight``,
    ``g = ||weight||``: the same kernel."""
    tensors = weight_norm_tensors(sd)
    normed = {name: m for name, m in module.named_modules() if isinstance(m, WeightNormed)}
    for name in normed:
        w = tensors.pop(f"{name}.weight", None)
        if w is not None and f"{name}.weight_v" not in tensors:
            tensors[f"{name}.weight_v"], tensors[f"{name}.weight_g"] = w.float(), norm_but_first(w)
        elif w is not None:
            tensors[f"{name}.weight"] = w  # both forms: strict loading refuses it
    own = module.state_dict()
    for key, t in tensors.items():
        if key in own and tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model shape {tuple(own[key].shape)}")
    module.load_state_dict(tensors, strict=True)
    for name, m in normed.items():  # the f32 fold, then in the module's dtype
        m.fold(fold_weight(tensors[f"{name}.weight_v"], tensors[f"{name}.weight_g"]))
    _pack_codecs(module)


def _pack_codecs(module: nn.Module) -> None:
    """``pack`` every codec encoder and decoder inside ``module``."""
    for m in module.modules():
        if isinstance(m, (Encoder, Decoder)):
            m.pack()


@torch.no_grad()
def init_random_weights(module: nn.Module, seed: int, *, snake_alpha: float | None = None) -> None:
    """Fill every parameter of ``module`` from ``seed``.

    Convs (weight-normed or not): U(+-1/sqrt(fan_in)) as torch initialises
    them, a weight-normed one's ``g = ||v||`` (so its kernel is v, as the
    JAX package initialises it); linears and the stacked logits head:
    N(0, 1/fan_in); embeddings, codebooks and the learned tokens: N(0, 1);
    snake alphas U(0.5, 2), so that a decode exercises them, or
    ``snake_alpha`` (1.0 for a training run's start, as the JAX package
    initialises them); norm scales: 1; other biases: 0.
    """
    gens: dict[torch.device, torch.Generator] = {}

    def gen(p: torch.Tensor) -> torch.Generator:
        if p.device not in gens:
            gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
        return gens[p.device]

    def uniform(p: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        p.uniform_(-bound, bound, generator=gen(p))

    done: set[int] = set()
    for m in module.modules():
        own = list(m.parameters(recurse=False))
        if isinstance(m, WeightNormed):
            # conv: C_in/groups * K; transposed conv (C_in, C_out, K): C_out * K
            v = m.weight_v
            fan_in = math.prod(v.shape[1:])
            uniform(v, fan_in)
            uniform(m.bias, fan_in)
            m.weight_g.copy_(norm_but_first(v))
            m.fold()
        elif isinstance(m, nn.Conv1d):
            uniform(m.weight, m.weight.shape[1] * m.weight.shape[2])
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, m.in_features ** -0.5, generator=gen(m.weight))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _StackedLogits):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=gen(m.weight))
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen(m.weight))
        elif isinstance(m, Snake):
            if snake_alpha is None:
                m.alpha.uniform_(0.5, 2.0, generator=gen(m.alpha))
            else:
                m.alpha.fill_(snake_alpha)
        elif isinstance(m, ChanLayerNorm):
            for p in own:
                p.fill_(1.0)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, TextToSemantic):
            m.length_token.normal_(0.0, 1.0, generator=gen(m.length_token))
        elif isinstance(m, InjectionConformer):
            m.mask_token.normal_(0.0, 1.0, generator=gen(m.mask_token))
        else:
            continue
        done.update(id(p) for p in own)
    missed = [n for n, p in module.named_parameters() if id(p) not in done]
    if missed:
        raise RuntimeError(f"init_random_weights: no rule for {missed[:5]}")
    _pack_codecs(module)
