"""Model directories of both packages on the same seeded weights, for the
tests of the port's loaders and CLIs (tests/test_torch_hub.py,
tests/test_torch_cli.py).

``model_dirs`` writes, under one root:

- ``jax/{codec,t2s,s2a,hubert}``: the JAX package's own directories
  (``edm_tts_tpu.utils.hub.save_*``, orbax), which its loaders and the root
  CLIs read;
- ``ref/{codec,t2s,s2a}``: the reference format, made from the JAX
  directories by ``utility_scripts/export_torch.py`` itself (the s2a with
  ``acoustic_model_path`` and legacy ``weight_g``/``weight_v`` pairs, the
  codec with parametrize pairs);
- ``port/{t2s,s2a}``: the port's own ``pytorch_model.bin`` directories
  (``train.export``);
- ``hf/hubert``: a local HF HuBERT directory (``config.json`` in HF's keys,
  ``model.safetensors`` with the ``hubert.`` prefix, the positional conv as
  a ``weight_g``/``weight_v`` pair) with its centroids in each of the three
  file formats, from which ``utility_scripts/convert_hubert.py`` makes
  ``jax/hubert``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

import edm_tts_tpu.utils.hub as j_hub
from edm_tts_tpu.models.codec import Codec as JCodec
from edm_tts_tpu_torch.models.hubert import HubertConfig, hf_state_dict_from_jax_params
from edm_tts_tpu_torch.train import export
from edm_tts_tpu_torch.utils.hub import config_dict
from torch_port_parity import TINY_HUBERT, hubert_pair, s2a_pair, t2s_pair

ROOT = Path(__file__).resolve().parent.parent
CENTROID_FILES = ("centroids.npy", "centroids.npz", "kmeans.pt")


def tool(name: str):
    """A script of utility_scripts/ as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "utility_scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def argv(*args: str):
    saved = sys.argv
    sys.argv = [*args]
    try:
        yield
    finally:
        sys.argv = saved


def write_hf_hubert(path: Path, variables, centers: np.ndarray) -> None:
    """An HF HuBERT directory of the JAX HuBERT ``variables``, with
    ``centers`` in every file of CENTROID_FILES."""
    from safetensors.numpy import save_file

    cfg = HubertConfig(**TINY_HUBERT)
    path.mkdir(parents=True, exist_ok=True)
    sd = hf_state_dict_from_jax_params(cfg, variables)
    save_file({f"hubert.{k}": np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))
    hf = {k: v for k, v in config_dict(cfg, "hubert").items() if k != "feat_proj_layer_norm"}
    (path / "config.json").write_text(json.dumps(hf))
    np.save(path / "centroids.npy", centers)
    np.savez(path / "centroids.npz", centers=centers)
    torch.save(torch.from_numpy(centers), path / "kmeans.pt")


def model_dirs(root: Path, t2s_cfg: dict, s2a_cfg: dict, seed: int = 0) -> dict:
    """The directories above, and the models they were made from:
    ``{"dirs": {...}, "t2s": (jax model, variables, port model), "s2a": ...,
    "hubert": (jax tokenizer, params, port tokenizer)}``."""
    t2s = t2s_pair(seed=seed, cfg=t2s_cfg)
    s2a = s2a_pair(seed=seed, cfg=s2a_cfg)
    hubert = hubert_pair(seed=seed, output_layer=TINY_HUBERT["num_hidden_layers"],
                         num_clusters=s2a_cfg["num_semantic_tokens"])
    jt2s, t2s_vars, port_t2s = t2s
    js2a, s2a_vars, port_s2a = s2a
    d = {name: root / name for name in ("jax", "ref", "port", "hf")}
    dirs = {f"{kind}_{m}": str(d[kind] / m) for kind in ("jax", "ref") for m in ("codec", "t2s", "s2a")}
    dirs.update(port_t2s=str(d["port"] / "t2s"), port_s2a=str(d["port"] / "s2a"),
                jax_hubert=str(d["jax"] / "hubert"), hf_hubert=str(d["hf"] / "hubert"))
    # the s2a's own codec is the one the tokenizer reads too
    j_hub.save_codec(dirs["jax_codec"], JCodec(js2a.cfg.codec), {"params": s2a_vars["params"]["codec"]})
    j_hub.save_t2s(dirs["jax_t2s"], jt2s, t2s_vars)
    j_hub.save_s2a(dirs["jax_s2a"], js2a, s2a_vars)
    exporter = tool("export_torch")
    exporter.export_codec(dirs["jax_codec"], dirs["ref_codec"], legacy_wn=False)
    exporter.export_t2s(dirs["jax_t2s"], dirs["ref_t2s"])
    exporter.export_s2a(dirs["jax_s2a"], dirs["ref_s2a"], legacy_wn=True)
    export.save_t2s(dirs["port_t2s"], port_t2s)
    export.save_s2a(dirs["port_s2a"], port_s2a)
    _, sem_params, port_sem = hubert
    centers = port_sem.cluster_centers.numpy()
    write_hf_hubert(Path(dirs["hf_hubert"]), {"params": sem_params["hubert"]["params"]}, centers)
    with argv("convert_hubert.py", "--hf_dir", dirs["hf_hubert"], "--output", dirs["jax_hubert"],
              "--kmeans", str(Path(dirs["hf_hubert"]) / "centroids.npy")):
        tool("convert_hubert").main()
    return {"dirs": dirs, "t2s": t2s, "s2a": s2a, "hubert": hubert}


def prompt_audio(seconds: float, sr: int, seed: int = 0) -> np.ndarray:
    """A seeded tone-plus-noise waveform in [-1, 1]."""
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    wav = 0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t)
    return (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
