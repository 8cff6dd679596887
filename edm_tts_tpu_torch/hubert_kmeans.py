"""HuBERT feature dump + k-means semantic codebook (the port's counterpart of
utility_scripts/hubert_kmeans.py).

    python -m edm_tts_tpu_torch.hubert_kmeans --data_dir D --hubert_model HF_DIR \
        --output OUT_DIR [--k 1024 --frames_per_cluster 1000 --niter 20 --nredo 5 \
        --seed 42 --output_layer 18 --max_seconds 30] [--device cuda|cpu]

Streams a LibriSpeech split (``--subset``, train-clean-100 by default)
through HuBERT in f32 to ``--output_layer`` (the first ``--max_seconds`` of
each utterance, one utterance at a time, as the JAX tool runs it), collects
``k * frames_per_cluster`` frames, fits ``k`` centroids with
``ops.kmeans.kmeans`` (Lloyd's, best of ``nredo``) and writes them as
``centroids.npy`` into ``--output``: a local HF HuBERT directory that
``utils.hub.load_semantic_tokenizer`` reads (the HF snapshot's config and
weights are copied there when ``--output`` is another directory; a centroid
file of another format there is replaced, so the new fit is the one found).

Runs on the card (``--device cuda``, the default: HuBERT's attention
through K3's f32 kernel, TF32 off; without a card it is an error) or on the
CPU (``--device cpu``); on the card it prints its kernel launches last.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil

import numpy as np
import torch

from edm_tts_tpu_torch.data.manifests import librispeech_manifest
from edm_tts_tpu_torch.data.pipeline import load_audio_segments
from edm_tts_tpu_torch.inference import device_of, print_launches
from edm_tts_tpu_torch.ops.kmeans import kmeans
from edm_tts_tpu_torch.ops.precision import exact_f32
from edm_tts_tpu_torch.utils import hub


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--subset", default="train-clean-100")
    ap.add_argument("--hubert_model", required=True,
                    help="a local HF HuBERT directory (config.json + weights)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--frames_per_cluster", type=int, default=1000)
    ap.add_argument("--niter", type=int, default=20)
    ap.add_argument("--nredo", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--output_layer", type=int, default=18)
    ap.add_argument("--max_seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, an error without one) or 'cpu'")
    args = ap.parse_args(argv)
    device = device_of(ap, args.device)
    precision = exact_f32() if device.type == "cuda" else contextlib.nullcontext()
    with torch.no_grad(), precision:
        centers, semantic = fit(args, device)
    write_centroids(args.hubert_model, args.output, centers)
    print(f"exported semantic tokenizer (hubert + {args.k} centroids, layer "
          f"{semantic.output_layer}) to {args.output}", flush=True)
    print_launches(device)


def fit(args, device: torch.device):
    """The features of the manifest's utterances and their centroids
    ``(k, H)`` f32 on the host, with the HuBERT that made them."""
    # output_layer is clamped to the model's depth (tiny rehearsal models
    # have fewer than 18 layers)
    semantic = hub.load_hubert(args.hubert_model, args.output_layer, args.k, device=device)
    target = args.k * args.frames_per_cluster
    max_samples = int(args.max_seconds * 16000)
    feats, total = [], 0
    for ex in librispeech_manifest(args.data_dir, args.subset):
        seg = next(load_audio_segments(ex, 16000, None))
        audio = torch.from_numpy(seg["audio"][:max_samples]).to(device)[None]
        h = semantic.hidden_states(audio)[0].float()
        feats.append(h)
        total += h.shape[0]
        if total >= target:
            break
    x = torch.cat(feats)[:target]
    del feats
    print(f"collected {x.shape[0]} frames of dim {x.shape[1]}", flush=True)
    history: list = []
    centers, inertia = kmeans(x, args.k, niter=args.niter, nredo=args.nredo, seed=args.seed,
                              history=history)
    print(f"kmeans done, inertia {float(inertia):.1f} (per run, first and last iteration: "
          f"{[(round(h[0], 1), round(h[-1], 1)) for h in history if h]})", flush=True)
    return centers.cpu().numpy(), semantic


def write_centroids(hubert_dir: str, output: str, centers: np.ndarray) -> None:
    """``centers`` as ``output/centroids.npy`` beside a copy of the HF
    snapshot's config and weights (when ``output`` is another directory);
    other centroid files in ``output`` are removed."""
    os.makedirs(output, exist_ok=True)
    if os.path.realpath(hubert_dir) != os.path.realpath(output):
        for name in ("config.json", hub.SAFETENSORS_NAME, hub.TORCH_NAME):
            if os.path.exists(os.path.join(hubert_dir, name)):
                shutil.copy2(os.path.join(hubert_dir, name), os.path.join(output, name))
    for name in hub.CENTROID_NAMES:
        if name != "centroids.npy" and os.path.exists(os.path.join(output, name)):
            os.remove(os.path.join(output, name))
    np.save(os.path.join(output, "centroids.npy"), centers.astype(np.float32))


if __name__ == "__main__":
    main()
