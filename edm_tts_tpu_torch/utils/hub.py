"""Model directories: the ``from_pretrained`` side of the port (port of
edm_tts_tpu/utils/hub.py).

One loader per stage, each building the model in ``dtype`` on ``device``
(the card unless the caller asks for the CPU). A codec, t2s or s2a
directory holds ``config.json`` and its weights in one of two formats:

- the reference format that ``utility_scripts/export_torch.py`` writes and
  the reference's ``from_pretrained`` reads: ``model.safetensors`` under the
  reference's key names, weight-norm pairs in either torch spelling
  (``weight_g``/``weight_v`` or ``parametrizations.weight.original0/1``);
  an s2a's ``config.json`` names its codec's directory in
  ``acoustic_model_path`` (``acoustic_model_dir`` resolves it);
- the port's own, as ``train/export.py`` writes it: ``pytorch_model.bin``
  (a ``torch.save``d state dict, the codec's weight-norm pairs as its
  modules hold them; an older one's folded ``.weight`` loads too) and a
  ``config.json`` that embeds the s2a's codec config.

Both load strictly through ``convert.load_reference_state_dict``. The s2a's
codec takes its config from ``acoustic_model_path`` when there is one, else
from the config's embedded ``codec``; its weights are the s2a file's
``acoustic_model.*`` entries when it has them, else the codec directory's.

A HuBERT directory is a local HF snapshot (``config.json`` in HF's format,
``model.safetensors`` or ``pytorch_model.bin``, keys with or without the
``hubert.`` prefix), as utility_scripts/convert_hubert.py reads one; its
k-means centroids come from an explicit file or from ``centroids.pt``,
``centroids.npz`` or ``centroids.npy`` inside the directory.

``save_reference`` and ``save_hubert_hf`` write those formats from the
port's models (the codec's weight-norm pairs as its modules hold them,
``weight_v`` / ``weight_g``: a trained codec keeps its trained pairs), so
that a directory made here is read by the loaders above and by the
reference.
``safetensors`` is not installed on the card's machine: the files go
through ``utils.safetensors``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from edm_tts_tpu_torch.convert import load_reference_state_dict
from edm_tts_tpu_torch.models import quantize as quantization
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.hubert import HubertConfig, load_hf_state_dict
from edm_tts_tpu_torch.models.hubert.convert import POS_CONV
from edm_tts_tpu_torch.models.s2a import InjectionConformer, S2AConfig
from edm_tts_tpu_torch.models.t2s import T2SConfig, TextToSemantic
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer, SemanticTokenizerHubert
from edm_tts_tpu_torch.utils import safetensors

SAFETENSORS_NAME = "model.safetensors"
TORCH_NAME = "pytorch_model.bin"
CENTROID_NAMES = ("centroids.pt", "centroids.npz", "centroids.npy")


def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_weights(path: str) -> dict[str, np.ndarray]:
    """The state dict of a model directory as f32-or-integer numpy arrays:
    ``model.safetensors`` if present, else ``pytorch_model.bin``."""
    st, pt = os.path.join(path, SAFETENSORS_NAME), os.path.join(path, TORCH_NAME)
    if os.path.exists(st):
        sd = safetensors.load_file(st)
    elif os.path.exists(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no {SAFETENSORS_NAME} or {TORCH_NAME} under {path}")
    return {k: _numpy(v) for k, v in sd.items()}


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype in (torch.bfloat16, torch.float16) else v).numpy()
    return np.asarray(v)


def load_codec(path: str, *, device="cuda", dtype=torch.float32) -> Codec:
    codec = Codec(CodecConfig.from_dict(read_config(path)), device=device, dtype=dtype)
    load_reference_state_dict(codec, load_weights(path))
    return codec.eval()


def load_t2s(path: str, *, device="cuda", dtype=torch.float32,
             quantize: str = "none") -> TextToSemantic:
    model = TextToSemantic(T2SConfig.from_dict(read_config(path)), device=device, dtype=dtype)
    load_reference_state_dict(model, load_weights(path))
    return quantization.quantize_t2s(model.eval(), quantize)


def acoustic_model_dir(path: str, config: dict) -> str | None:
    """The codec directory an s2a config names (``acoustic_model_path``):
    as given (absolute or relative to the working directory), else relative
    to the s2a directory, else its last component inside the s2a directory
    (an export moved since it was written); None when the config names
    none."""
    ref = config.get("acoustic_model_path")
    if not ref:
        return None
    for candidate in (ref, os.path.join(path, ref), os.path.join(path, os.path.basename(ref))):
        if os.path.isfile(os.path.join(candidate, "config.json")):
            return candidate
    raise FileNotFoundError(f"{path}: acoustic_model_path {ref!r} is not a codec directory")


def load_s2a(path: str, *, device="cuda", dtype=torch.float32,
             quantize: str = "none") -> InjectionConformer:
    config = read_config(path)
    codec_dir = acoustic_model_dir(path, config)
    if codec_dir is not None:
        config = {**config, "codec": read_config(codec_dir)}
    model = InjectionConformer(S2AConfig.from_dict(config), device=device, dtype=dtype)
    sd = load_weights(path)
    if not any(k.startswith("acoustic_model.") for k in sd):
        if codec_dir is None:
            raise ValueError(f"{path}: the weights hold no codec (acoustic_model.*) and the "
                             "config names no acoustic_model_path")
        sd.update({f"acoustic_model.{k}": v for k, v in load_weights(codec_dir).items()})
    load_reference_state_dict(model, sd)
    return quantization.quantize_s2a(model.eval(), quantize)


def hubert_config_from_hf(hf: dict) -> HubertConfig:
    """An HF HuBERT ``config.json`` as a ``HubertConfig`` (the table of
    utility_scripts/convert_hubert.py, with HF's defaults)."""
    return HubertConfig(
        conv_dim=tuple(hf["conv_dim"]),
        conv_kernel=tuple(hf["conv_kernel"]),
        conv_stride=tuple(hf["conv_stride"]),
        conv_bias=hf.get("conv_bias", True),
        feat_extract_norm=hf.get("feat_extract_norm", "layer"),
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        num_conv_pos_embeddings=hf.get("num_conv_pos_embeddings", 128),
        num_conv_pos_embedding_groups=hf.get("num_conv_pos_embedding_groups", 16),
        do_stable_layer_norm=hf.get("do_stable_layer_norm", True),
    )


def load_centroids(path: str) -> np.ndarray:
    """k-means centroids ``(K, H)`` from a ``.pt``, ``.npz`` (its first
    array) or ``.npy`` file."""
    if path.endswith(".pt"):
        return np.asarray(torch.load(path, map_location="cpu"))
    if path.endswith(".npz"):
        blob = np.load(path)
        return blob[list(blob.keys())[0]]
    return np.load(path)


def find_centroids(path: str) -> str:
    for name in CENTROID_NAMES:
        if os.path.exists(os.path.join(path, name)):
            return os.path.join(path, name)
    raise FileNotFoundError(f"no k-means centroids ({', '.join(CENTROID_NAMES)}) under {path}; "
                            "pass centroids=")


def load_hubert(path: str, output_layer: int = 18, num_clusters: int = 1024, *,
                device="cuda", dtype=torch.float32) -> SemanticTokenizerHubert:
    """HuBERT from a local HF directory, to ``output_layer``, with
    ``num_clusters`` zero centroids (``hubert_kmeans`` fits them)."""
    sem = SemanticTokenizerHubert(hubert_config_from_hf(read_config(path)), output_layer,
                                  num_clusters, device=device, dtype=dtype)
    sd = {k.removeprefix("hubert."): v for k, v in load_weights(path).items()}
    load_hf_state_dict(sem.hubert, sd)
    return sem.eval()


def load_semantic_tokenizer(path: str, output_layer: int = 18, *, centroids: str | None = None,
                            device="cuda", dtype=torch.float32) -> SemanticTokenizerHubert:
    """HuBERT from a local HF directory, to ``output_layer``, with the
    k-means centroids of ``centroids`` (a file) or of the directory."""
    centers = load_centroids(centroids or find_centroids(path)).astype(np.float32)
    sem = load_hubert(path, output_layer, centers.shape[0], device=device, dtype=dtype)
    sem.cluster_centers.copy_(torch.from_numpy(centers))
    return sem


def build_audio_tokenizer(codec_path: str, hubert_path: str, *, device="cuda",
                          dtype=torch.float32) -> AudioTokenizer:
    """The joint tokenizer from a codec directory and a HuBERT directory."""
    return AudioTokenizer(load_codec(codec_path, device=device, dtype=dtype),
                          load_semantic_tokenizer(hubert_path, device=device, dtype=dtype))


# -- writers ----------------------------------------------------------------
def config_dict(cfg, model_type: str) -> dict:
    """A dataclass config as export_torch.py writes it: tuples as lists,
    ``model_type`` added."""
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    d["model_type"] = model_type
    return d


def _numpy_state_dict(model: nn.Module) -> dict[str, np.ndarray]:
    """``model``'s state dict as numpy, floats in f32; a weight-normed conv
    writes its own ``weight_v`` / ``weight_g`` (the reference's legacy
    spelling, which torch's ``weight_norm`` parametrization also loads)."""
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in model.state_dict().items()}


def save_reference(path: str, model: Codec | TextToSemantic | InjectionConformer,
                   codec_dir: str | None = None) -> None:
    """Write ``model`` in the reference format (``config.json`` +
    ``model.safetensors``, f32). An s2a's codec is named by
    ``acoustic_model_path`` = ``codec_dir`` (which must hold it, e.g. from
    ``save_reference(codec_dir, s2a.acoustic_model)``); its weights stay in
    the s2a's file under ``acoustic_model.*`` too, as export_torch.py
    writes them."""
    os.makedirs(path, exist_ok=True)
    if isinstance(model, Codec):
        cfg = config_dict(model.config, "dac")
    elif isinstance(model, TextToSemantic):
        cfg = config_dict(model.cfg, "text_to_semantic_w_length")
    else:
        if codec_dir is None:
            raise ValueError("save_reference: an s2a needs codec_dir (its acoustic_model_path)")
        cfg = config_dict(model.cfg, "injection_conformer")
        cfg.pop("codec")
        cfg["acoustic_model_path"] = codec_dir
    safetensors.save_file(_numpy_state_dict(model), os.path.join(path, SAFETENSORS_NAME))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)


def save_hubert_hf(path: str, semantic: SemanticTokenizerHubert,
                   centroids: str = CENTROID_NAMES[0]) -> None:
    """Write ``semantic``'s HuBERT as a local HF directory (HF's
    ``config.json`` keys, ``model.safetensors`` with the positional conv's
    weight norm as HF's ``dim=2`` pair) and its centroids as ``centroids``
    (``.pt``, ``.npz`` or ``.npy``) inside it."""
    os.makedirs(path, exist_ok=True)
    cfg = semantic.config
    hf = {k: v for k, v in config_dict(cfg, "hubert").items() if k != "feat_proj_layer_norm"}
    hf["architectures"] = ["HubertModel"]
    sd = {k: v.detach().float().cpu().numpy() for k, v in semantic.hubert.state_dict().items()}
    w = sd.pop(f"{POS_CONV}.weight")
    sd[f"{POS_CONV}.parametrizations.weight.original0"] = np.sqrt(
        (w.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True)).astype(np.float32)
    sd[f"{POS_CONV}.parametrizations.weight.original1"] = w
    safetensors.save_file(sd, os.path.join(path, SAFETENSORS_NAME))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=2, sort_keys=True)
    centers = semantic.cluster_centers.detach().float().cpu()
    target = os.path.join(path, centroids)
    if centroids.endswith(".pt"):
        torch.save(centers, target)
    elif centroids.endswith(".npz"):
        np.savez(target, centers=centers.numpy())
    else:
        np.save(target, centers.numpy())
