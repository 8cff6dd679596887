"""Closed-loop rehearsal of the port (the counterpart of
scripts/closed_loop.py): the reference README's whole workflow, end to end,
through the port's own CLIs alone, at tiny but real sizes.

    python -m edm_tts_tpu_torch.closed_loop --root R [--codec_steps 300 \
        --token_steps 300 --k 32] [--device cuda|cpu]

  0. in this process: a LibriSpeech-layout FLAC set with transcripts
     (``make_dataset``) and a random HuBERT written as a local HF directory
     (``utils.hub.save_hubert_hf``); the reference starts from pretrained
     facebook/hubert-large-ll60k, so HuBERT's weights are out of scope;
  1. ``train.run_codec``: GAN-train the codec -> ``R/codec/best_model``;
  2. ``hubert_kmeans``: k-means centroids over HuBERT's states ->
     ``R/hubert_semantic``;
  3. ``dump_tokens``: aligned token shards with the self-trained codec and
     the fitted tokenizer -> ``R/codes``;
  4. ``train.run_t2s``: train t2s on the shards -> ``R/t2s/export``;
  5. ``train.run_s2a``: train s2a on them with the self-trained codec ->
     ``R/s2a/export``;
  6. ``inference``: a wav from text and a speaker prompt with the three
     self-trained directories -> ``R/out.wav``.

Each of stages 1-6 is a subprocess (``python -m edm_tts_tpu_torch.<cli>``)
whose output goes to ``R/logs/<stage>.log``; a stage whose artifact exists
is skipped, so a loop that failed half-way resumes where it stopped. A
failing stage ends the run with the tail of its log. Every stage runs on
``--device`` (the card by default; without one it is an error, as in the
other CLIs), and every trainer and the dump at f32. Each stage's wall
seconds and, on the card, its ``kernel launches`` line are printed. The
final check: a 16 kHz wav of exactly ``GT_LENGTH * 320`` samples with a
nonzero RMS.

``run`` takes the three recipes (YAML text, or a dict, written as JSON for
machines without PyYAML), the HuBERT to write and the tool's sizes, so a
caller can run the loop at other widths; ``main`` passes the templates
below at the tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SR = 16000
WORDS = [
    "".join(chr(97 + (i * 5 + j * 11) % 26) for j in range(3 + (i * 7) % 5))
    for i in range(48)
]
# the directory a stage's ``python -m edm_tts_tpu_torch.<cli>`` runs from
CHECKOUT = Path(__file__).resolve().parent.parent
LAUNCHES = "kernel launches: "
# the JAX script's k-means restarts and inference request sizes
NREDO, GT_LENGTH, MAX_SPEECH_LEN = 2, 100, 128


def make_dataset(root: str, n_speakers=3, n_utts=20, seed=0):
    """LibriSpeech-layout FLACs (harmonics + AM + noise, 'speech-shaped')
    with transcript files (librispeech_manifest glob:
    <root>/LibriSpeech/<split>/<spk>/<chap>/*.trans.txt)."""
    from edm_tts_tpu_torch.data.flac_encoder import encode_flac

    rng = np.random.default_rng(seed)
    split = os.path.join(root, "LibriSpeech", "train-clean-100")
    n = 0
    for spk in range(n_speakers):
        chap_dir = os.path.join(split, str(100 + spk), "1")
        os.makedirs(chap_dir, exist_ok=True)
        lines = []
        for u in range(n_utts):
            dur = float(rng.uniform(3.2, 4.0))
            t = np.arange(int(dur * SR)) / SR
            f0 = float(rng.uniform(90, 300))
            sig = np.zeros_like(t, dtype=np.float64)
            for h in range(1, 6):
                sig += (0.4 / h) * np.sin(
                    2 * np.pi * h * f0 * t + rng.uniform(0, 2 * np.pi)
                )
            env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(1.5, 5.0) * t)
            sig = sig * env + 0.01 * rng.standard_normal(t.shape)
            sig = 0.7 * sig / (np.abs(sig).max() + 1e-9)
            ints = np.clip(sig * 32767, -32768, 32767).astype(np.int64)
            utt_id = f"{100 + spk}-1-{u:04d}"
            with open(os.path.join(chap_dir, utt_id + ".flac"), "wb") as f:
                f.write(encode_flac(ints[None], sample_rate=SR,
                                    subframe_kind="fixed", order=2, param=12))
            text = " ".join(
                WORDS[j] for j in rng.integers(0, len(WORDS),
                                               int(rng.integers(6, 12)))
            ).upper()
            lines.append(f"{utt_id} {text}")
            n += 1
        with open(os.path.join(chap_dir, "1.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    print(f"dataset: {n} utterances under {split}")


def make_tiny_hubert():
    """A random tiny HuBERT from seed 7 (the JAX script's configuration) on
    the CPU: the frozen external feature extractor, whose pretrained weights
    the reference loads."""
    from edm_tts_tpu_torch.convert import init_random_weights
    from edm_tts_tpu_torch.models.hubert import HubertConfig
    from edm_tts_tpu_torch.models.tokenizer.semantic_hubert import SemanticTokenizerHubert

    cfg = HubertConfig(
        conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    )
    hubert = SemanticTokenizerHubert(cfg, num_clusters=1, device="cpu")
    init_random_weights(hubert, 7)
    return hubert.eval()


CODEC_YAML = """\
output_dir: {root}/codec
generator_args:
  encoder_dim: 8
  decoder_dim: 64
  n_codebooks: 4
  codebook_size: 64
  codebook_dim: 4
discriminator_args:
  mpd_periods: [2, 3]
  mrd_fft_sizes: [512, 256]
dataset_args:
  path: librispeech
  name: train-clean-100
  data_dir: {root}/data
training_segment_length: 0.38
validation_segment_length: 2.0
validation_split: 4
shuffle_buffer_size: 64
per_device_train_batch_size: 8
max_steps: {codec_steps}
logging_steps: 25
eval_steps: {codec_eval}
save_steps: {codec_eval}
gen_optimizer_args: {{lr: 2.0e-4, betas: [0.8, 0.99]}}
disc_optimizer_args: {{lr: 2.0e-4, betas: [0.8, 0.99]}}
seed: 42
"""

T2S_YAML = """\
output_dir: {root}/t2s
extra_model_params:
  hidden_size: 64
  semantic_vocab_size: {k}
  main_encoder_num_layers: 2
  main_encoder_num_heads: 4
  length_predictor_num_layers: 1
  length_predictor_num_heads: 4
dataset_args:
  data_dir: {root}/codes
  format: native
seed: 42
per_device_train_batch_size: 8
max_steps: {steps}
learning_rate: 1.0e-3
warmup_steps: 30
logging_steps: 25
eval_steps: 1000000
save_steps: {steps}
bf16: false
"""

S2A_YAML = """\
output_dir: {root}/s2a
acoustic_model_path: {root}/codec/best_model
extra_model_params:
  num_semantic_tokens: {k}
  hidden_size: 64
  injection_layers: [1, 2]
  encoder_config:
    depth: 4
    heads: 4
dataset_args:
  data_dir: {root}/codes
  format: native
training_segment_length: 2.0
seed: 42
per_device_train_batch_size: 8
max_steps: {steps}
learning_rate: 1.0e-3
warmup_steps: 30
logging_steps: 25
eval_steps: 1000000
save_steps: {steps}
bf16: false
"""
# the JAX script's inference request
TEXT = "hello closed loop synthesis test."


def launch_counts(log: str) -> dict | None:
    """The last ``kernel launches: {...}`` line of a stage's output (the
    CLIs print it on the card), or None."""
    lines = [line for line in log.splitlines() if line.startswith(LAUNCHES)]
    return json.loads(lines[-1][len(LAUNCHES):]) if lines else None


def run_stage(name: str, cmd: list[str], root: str,
              done_path: str | None = None) -> dict:
    """Run one CLI stage from the checkout, its output teed to
    ``<root>/logs/<name>.log``; skip it if ``done_path`` already exists.
    Returns its command, wall seconds, log path and kernel launches."""
    log = os.path.join(root, "logs", name + ".log")
    os.makedirs(os.path.dirname(log), exist_ok=True)
    result = {"cmd": cmd, "seconds": 0.0, "log": log, "launches": None, "skipped": True}
    if done_path and os.path.exists(done_path):
        print(f"--- {name}: SKIP (exists: {done_path})", flush=True)
        return result
    print(f"--- {name}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    with open(log, "w") as f:
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=CHECKOUT)
    dt = time.time() - t0
    with open(log) as f:
        text = f.read()
    if p.returncode != 0:
        print(text[-3000:])
        raise SystemExit(f"stage {name} FAILED (rc={p.returncode}, {log})")
    result.update(seconds=dt, launches=launch_counts(text), skipped=False)
    print(f"    ok in {dt:.2f}s ({log}); kernel launches {result['launches']}", flush=True)
    return result


def write_recipe(path: str, recipe: str | dict) -> None:
    """YAML text as it is; a dict as JSON (which is YAML too)."""
    with open(path, "w") as f:
        f.write(recipe if isinstance(recipe, str) else json.dumps(recipe))


def check_wav(path: str, gt_length: int) -> dict:
    """The JAX script's final check: 16 kHz, exactly ``gt_length * 320``
    samples, nonzero RMS."""
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    assert sr == SR and wav.shape[0] == gt_length * 320 and rms > 0, (sr, wav.shape, rms)
    return {"seconds": wav.shape[0] / sr, "samples": int(wav.shape[0]), "rms": rms}


def run(root: str, *, codec_recipe: str | dict, t2s_recipe: str | dict,
        s2a_recipe: str | dict, hubert, k: int, frames_per_cluster: int = 50,
        device: str = "cuda", n_speakers: int = 3, n_utts: int = 20, pred_iters: int = 4,
        s2a_steps: int = 4) -> dict:
    """The seven stages under ``root``. The recipes write their outputs
    where the templates do (``<root>/codec``, ``<root>/t2s``,
    ``<root>/s2a``) and read ``<root>/data`` and ``<root>/codes``;
    ``hubert`` is the ``SemanticTokenizerHubert`` whose HuBERT stage 0
    writes. Returns each stage's result (``run_stage``), ``"wav"`` (the
    final check's numbers), ``"setup_seconds"`` (stage 0's wall) and
    ``"seconds"`` (the whole loop's)."""
    from edm_tts_tpu_torch.utils import hub

    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    py, dev = sys.executable, ["--device", device]
    t_all = time.time()
    stages = {}

    make_dataset(os.path.join(root, "data"), n_speakers, n_utts)
    hub.save_hubert_hf(os.path.join(root, "hubert_raw"), hubert)
    setup_seconds = time.time() - t_all
    print(f"--- 0_setup: the dataset and {root}/hubert_raw in {setup_seconds:.2f}s", flush=True)

    write_recipe(f"{root}/codec.yaml", codec_recipe)
    stages["codec_gan_training"] = run_stage(
        "1_codec", [py, "-m", "edm_tts_tpu_torch.train.run_codec", f"{root}/codec.yaml", *dev],
        root, done_path=f"{root}/codec/best_model")
    assert os.path.isdir(f"{root}/codec/best_model"), "no best_model export"

    stages["hubert_kmeans"] = run_stage(
        "2_kmeans",
        [py, "-m", "edm_tts_tpu_torch.hubert_kmeans",
         "--data_dir", f"{root}/data", "--subset", "train-clean-100",
         "--hubert_model", f"{root}/hubert_raw",
         "--output", f"{root}/hubert_semantic",
         "--k", str(k), "--frames_per_cluster", str(frames_per_cluster),
         "--nredo", str(NREDO), *dev],
        root, done_path=f"{root}/hubert_semantic")

    stages["dump_tokens"] = run_stage(
        "3_dump",
        [py, "-m", "edm_tts_tpu_torch.dump_tokens",
         "--dataset", "librispeech", "--data_dir", f"{root}/data",
         "--subset", "train-clean-100", "--output_dir", f"{root}/codes",
         "--codec_model", f"{root}/codec/best_model",
         "--hubert_model", f"{root}/hubert_semantic",
         "--batch_size", "4", "--dtype", "float32", *dev],
        root, done_path=f"{root}/codes/shard_0_00000.json")

    write_recipe(f"{root}/t2s.yaml", t2s_recipe)
    stages["t2s_training"] = run_stage(
        "4_t2s", [py, "-m", "edm_tts_tpu_torch.train.run_t2s", f"{root}/t2s.yaml", *dev],
        root, done_path=f"{root}/t2s/export")
    assert os.path.isdir(f"{root}/t2s/export")

    write_recipe(f"{root}/s2a.yaml", s2a_recipe)
    stages["s2a_training"] = run_stage(
        "5_s2a", [py, "-m", "edm_tts_tpu_torch.train.run_s2a", f"{root}/s2a.yaml", *dev],
        root, done_path=f"{root}/s2a/export")
    assert os.path.isdir(f"{root}/s2a/export")

    prompt = os.path.join(
        root, "data", "LibriSpeech", "train-clean-100", "100", "1",
        "100-1-0000.flac")
    stages["inference"] = run_stage(
        "6_inference",
        [py, "-m", "edm_tts_tpu_torch.inference", "-s", prompt,
         "-t", TEXT,
         "-o", f"{root}/out.wav",
         "--codec_model", f"{root}/codec/best_model",
         "--t2s_model", f"{root}/t2s/export",
         "--s2a_model", f"{root}/s2a/export",
         "--hubert_model", f"{root}/hubert_semantic",
         "--max_speech_len", str(MAX_SPEECH_LEN), "--gt_length", str(GT_LENGTH),
         "--pred_iters", str(pred_iters), "--s2a_steps", str(s2a_steps),
         "--dtype", "float32", *dev],
        root)

    wav = check_wav(f"{root}/out.wav", GT_LENGTH)
    seconds = time.time() - t_all
    print(f"\nCLOSED LOOP OK in {seconds:.2f}s: "
          f"out.wav {wav['seconds']:.2f}s rms={wav['rms']:.1f}")
    for name, r in stages.items():
        print(f"  {name:22s} {r['seconds']:9.2f}s  launches {r['launches']}")
    return {**stages, "wav": wav, "setup_seconds": setup_seconds, "seconds": seconds}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the loop's directory; a stage whose artifact is there is skipped")
    ap.add_argument("--codec_steps", type=int, default=300)
    ap.add_argument("--token_steps", type=int, default=300)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, an error without one) or 'cpu'")
    args = ap.parse_args(argv)
    from edm_tts_tpu_torch.inference import device_of

    device_of(ap, args.device)
    root = os.path.abspath(args.root)
    run(root,
        codec_recipe=CODEC_YAML.format(root=root, codec_steps=args.codec_steps,
                                       codec_eval=max(50, args.codec_steps // 3)),
        t2s_recipe=T2S_YAML.format(root=root, k=args.k, steps=args.token_steps),
        s2a_recipe=S2A_YAML.format(root=root, k=args.k, steps=args.token_steps),
        hubert=make_tiny_hubert(), k=args.k, device=args.device)


if __name__ == "__main__":
    main()
