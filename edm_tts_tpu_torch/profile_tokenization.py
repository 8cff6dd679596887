"""Where the time of one prompt tokenization goes on the card (path (g)).

    python3 -m edm_tts_tpu_torch.profile_tokenization [--seed N]

Builds path (g)'s models from a seeded random init in bf16: the default
codec (encoder d 64, strides 2/4/5/8, 12 levels; ``full_width_codec``) and
HuBERT-large (``HUBERT_LARGE_LL60K``) to layer 18 with 1024 centroids
(``full_width_semantic``). For a 3 s and a 10 s seeded prompt at 24 kHz
(``prompt_wav``) it prints the time of each part of a tokenization, run as
``TTSEngine.register_speaker`` runs it (``tokenize_in_parts``): the
resampler to 16 kHz on the card, the alignment pad and loudness
normalization on the host, the codec encoder (K1 on its 12 residual
units), the RVQ, HuBERT's conv stack (input normalization, 7 convs,
projection, positional conv), its 18 layers (K3 in each) and the
nearest-centroid assignment: host wall and CUDA-event time of each part
after a warm-up, medians of 3. Then the whole tokenization
(``AudioTokenizer.compute_codes`` after the resampler) under
``torch.profiler``: wall, device kernel time, busy share and the port's
kernels (``device_profile``). chip_smoke.py drives the same models and
functions.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from edm_tts_tpu_torch.convert import init_random_weights
from edm_tts_tpu_torch.models.codec import Codec, CodecConfig
from edm_tts_tpu_torch.models.hubert import HUBERT_LARGE_LL60K
from edm_tts_tpu_torch.models.tokenizer import AudioTokenizer, SemanticTokenizerHubert
from edm_tts_tpu_torch.ops.resample import resample

PROMPT_SR = 24000           # the prompts' rate: the resampler runs
PROMPT_SECONDS = (3.0, 10.0)
OUTPUT_LAYER = 18
NUM_CLUSTERS = 1024
CENTROID_SECONDS = 20.5     # 1025 frames of HuBERT states to draw 1024 centroids from


def prompt_wav(seconds: float, seed: int, sr: int = PROMPT_SR) -> np.ndarray:
    """A seeded speech-like f32 waveform: a voiced tone with a wandering
    pitch and its harmonics under syllable-rate envelopes, with noise."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    f0 = 120 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6.3))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(rng.uniform(0.2, 1.0) / h * np.sin(h * phase) for h in range(1, 9))
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6.3))
    wav = 0.1 * voice * envelope + 0.01 * rng.standard_normal(n)
    return wav.astype(np.float32)


def encoder_samples(seconds: float, sr: int = PROMPT_SR, cfg: CodecConfig = CodecConfig()) -> int:
    """Samples the codec encoder sees for a ``prompt_wav`` of ``seconds`` at
    ``sr``: resampled to the codec's rate (``ops.resample``'s ceil), then
    ``AudioTokenizer.pad`` (to the next hop multiple, plus hop/2)."""
    n = -(-round(seconds * sr) * cfg.sample_rate // sr)
    return n + (-n) % cfg.hop_length + cfg.hop_length // 2


def full_width_codec(device, seed: int, dtype=torch.bfloat16) -> Codec:
    """The default codec from ``seed`` (packed for its kernels)."""
    codec = Codec(CodecConfig(), device=device, dtype=dtype).eval()
    init_random_weights(codec, seed)
    return codec


@torch.no_grad()
def full_width_semantic(device, seed: int, dtype=torch.bfloat16) -> SemanticTokenizerHubert:
    """HuBERT-large to layer 18 from ``seed``, with 1024 centroids drawn from
    its own layer-18 states on a seeded 20.5 s waveform (k-means' random
    point init), so that a prompt's frames spread over the clusters as they
    do over trained ones."""
    sem = SemanticTokenizerHubert(HUBERT_LARGE_LL60K, OUTPUT_LAYER, NUM_CLUSTERS,
                                  device=device, dtype=dtype).eval()
    init_random_weights(sem, seed)
    wav = torch.from_numpy(prompt_wav(CENTROID_SECONDS, seed + 1, sem.sample_rate)).to(device)
    frames = sem.hidden_states(wav[None])[0].float()
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(frames.shape[0], generator=gen)[:NUM_CLUSTERS].to(frames.device)
    sem.cluster_centers.copy_(frames[pick])
    return sem


def _timed(fn):
    """(result, host wall ms, CUDA-event ms) of ``fn`` with the card idle
    before and synchronized after."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


PARTS = ("resample", "pad + loudness (host)") + AudioTokenizer.STEPS


@torch.no_grad()
def tokenize_in_parts(tok: AudioTokenizer, wav: np.ndarray, sr: int) -> tuple[dict, dict]:
    """``wav`` at ``sr`` through ``register_speaker``'s steps one part at a
    time (the resampler, ``AudioTokenizer.prepare`` and each of
    ``AudioTokenizer.run_steps``' steps): ({part: (host wall ms, CUDA-event
    ms)}, ``run_steps``' outputs)."""
    times = {}

    def part(name, fn):
        out, wall, dev_ms = _timed(fn)
        times[name] = (wall, dev_ms)
        return out

    x = part("resample", lambda: resample(torch.from_numpy(wav).to(tok.device), sr,
                                          tok.sample_rate).cpu().numpy())
    padded, normalized, _ = part("pad + loudness (host)", lambda: tok.prepare(x[None]))
    return times, tok.run_steps(normalized, padded, step=part)


def parts_median(tok: AudioTokenizer, wav: np.ndarray, sr: int, runs: int = 3) -> dict:
    """``tokenize_in_parts`` after one warm-up: the median of ``runs`` of each
    part's host wall and CUDA-event ms."""
    tokenize_in_parts(tok, wav, sr)
    runs_ = [tokenize_in_parts(tok, wav, sr)[0] for _ in range(runs)]
    return {p: tuple(statistics.median(r[p][i] for r in runs_) for i in (0, 1)) for p in PARTS}


def device_profile(fn) -> dict:
    """Untraced wall (s) of ``fn``, then under ``torch.profiler``: device
    kernel time (ms, the sum of the kernels' own time), kernel count, busy
    share (device time over the untraced wall) and the port's kernels
    ``{name: (ms, calls)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, wall_ms, _ = _timed(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours: dict[str, list] = {}
    for e in kernels:
        if "edm::" in e.key:
            k = ours.setdefault(e.key.split("edm::")[1].split("(")[0].split("<")[0], [0.0, 0])
            k[0] += e.self_device_time_total / 1e3
            k[1] += e.count
    return dict(wall_s=wall_ms / 1e3, device_ms=device_ms, kernels=sum(e.count for e in kernels),
                busy=device_ms / wall_ms, port_kernels={k: tuple(v) for k, v in ours.items()})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tokenization: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tok = AudioTokenizer(full_width_codec(dev, args.seed),
                         full_width_semantic(dev, args.seed + 2))
    for seconds in PROMPT_SECONDS:
        wav = prompt_wav(seconds, args.seed + int(seconds))
        parts = parts_median(tok, wav, PROMPT_SR)
        total = sum(w for w, _ in parts.values())
        for p, (wall, dev_ms) in parts.items():
            print(f"tokenize {seconds:.0f} s prompt: {p}: wall {wall:.3f} ms "
                  f"({100 * wall / total:.1f} %), CUDA events {dev_ms:.3f} ms", flush=True)
        x = resample(torch.from_numpy(wav).to(dev), PROMPT_SR, tok.sample_rate).cpu().numpy()
        prof = device_profile(lambda: tok.compute_codes(x[None]))
        print(f"tokenize {seconds:.0f} s prompt: compute_codes wall {prof['wall_s'] * 1e3:.3f} ms "
              f"({prof['wall_s'] / seconds:.5f} s per prompt s), device kernel time "
              f"{prof['device_ms']:.3f} ms ({prof['device_ms'] / 1e3 / seconds:.5f} s per prompt "
              f"s) in {prof['kernels']} kernels, busy share {prof['busy']:.3f}; port kernels "
              f"{prof['port_kernels']} ({smi})", flush=True)


if __name__ == "__main__":
    main()
