"""End-to-end zero-shot TTS from model directories: text + speaker prompt
file -> wav (port of the root inference.py, the same flags and behaviour).

    python -m edm_tts_tpu_torch.inference -s prompt.flac -t "Hello." -o out.wav \\
        --codec_model DIR --t2s_model DIR --s2a_model DIR --hubert_model DIR

Tokenizes the speaker prompt (a WAV or FLAC file, resampled to 16 kHz on the
host), then per group of utterances: the t2s MaskGIT sampler, the s2a
sampler on a canvas bucketed to ``--length_bucket`` with the padding masked,
and the codec's masked decode; or, with ``--one_shot``, the three stages
through ``pipeline.e2e_synthesize`` on a fixed ``--max_speech_len`` canvas.
``--text_file`` writes ``<stem>_<i>.wav`` per line; ``--long`` splits
``--text`` at sentence boundaries, synthesizes groups of at most
``--long_batch`` chunks and joins them into one file. The directories are
read by ``utils.hub`` (reference ``model.safetensors`` or the port's
``pytorch_model.bin``; HuBERT as a local HF directory with its centroids).

Runs on the card (``--device cuda``, the default; without a card it exits
with an error) or, when asked, on the CPU. Each group draws from its own
``torch.Generator`` seeded from ``--seed`` and the group's index (the port
cannot reproduce ``jax.random``'s streams). On the card the last line lists
the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from edm_tts_tpu_torch.data.audio_io import load_audio, save_wav
from edm_tts_tpu_torch.kernels import all_launches
from edm_tts_tpu_torch.models.s2a import s2a_sample
from edm_tts_tpu_torch.models.t2s import t2s_sample
from edm_tts_tpu_torch.ops.resample import resample_numpy
from edm_tts_tpu_torch.pipeline import e2e_synthesize
from edm_tts_tpu_torch.serving.chunking import default_chunk_chars, join_waveforms, split_text
from edm_tts_tpu_torch.utils import hub
from edm_tts_tpu_torch.utils.bucketing import bucket_length

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUANTIZE = ("none", "int8", "w8a8")
# a group's generator seed: --seed plus this stride per group index
GROUP_SEED_STRIDE = 1_000_003


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The flags both CLIs share: model directories, sampling, dtype,
    quantization and device."""
    ap.add_argument("--codec_model", default="exp/edm_tts/dac/best_model")
    ap.add_argument("--t2s_model", default="exp/edm_tts/text_to_semantic_w_length/")
    ap.add_argument("--s2a_model", default="exp/edm_tts/injection_conformer/")
    ap.add_argument("--hubert_model", default="exp/edm_tts/hubert_semantic")
    ap.add_argument("--pred_iters", type=int, default=16)
    ap.add_argument("--s2a_steps", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--max_speech_len", type=int, default=1250)
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--quantize", default="none", choices=QUANTIZE,
                    help="int8 t2s/s2a linears: 'int8' = weight-only (kernel K5), "
                         "'w8a8' = per-row int8 activations x int8 weights")
    ap.add_argument("--quantize_t2s", default=None, choices=QUANTIZE,
                    help="per-stage override of --quantize for t2s")
    ap.add_argument("--quantize_s2a", default=None, choices=QUANTIZE,
                    help="per-stage override of --quantize for s2a")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, an error without one) or 'cpu'")


def device_of(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """``--device`` as a torch device; an argparse error for a CUDA device
    on a machine without one (no quiet fall-back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {name}: no CUDA device here (pass --device cpu to run on the CPU)")
    return device


def print_launches(device: torch.device) -> None:
    if device.type == "cuda":
        print(f"kernel launches: {json.dumps(all_launches())}", flush=True)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", "--speaker_prompt", required=True)
    ap.add_argument("-t", "--text", default=None)
    ap.add_argument("--text_file", default=None,
                    help="batch mode: one utterance per line -> <output stem>_<i>.wav")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--length_bucket", type=int, default=64,
                    help="staged mode: round the s2a canvas up to this multiple (the "
                         "padding is masked)")
    ap.add_argument("--gt_length", type=int, default=None,
                    help="override the predicted speech length (tokens)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--long", action="store_true",
                    help="long-form mode: chunk --text at sentence boundaries sized to the "
                         "t2s canvas, synthesize the chunks in batches and join the "
                         "waveforms into one output file")
    ap.add_argument("--max_chunk_chars", type=int, default=None,
                    help="--long chunk budget (default: derived from --max_speech_len)")
    ap.add_argument("--long_batch", type=int, default=16,
                    help="--long synthesizes chunks in groups of at most this many")
    ap.add_argument("--crossfade_ms", type=float, default=30.0,
                    help="--long chunk-join crossfade")
    ap.add_argument("--gap_ms", type=float, default=0.0,
                    help="--long inter-chunk silence (disables crossfade)")
    ap.add_argument("--one_shot", action="store_true",
                    help="run t2s -> s2a -> decode through pipeline.e2e_synthesize on a "
                         "fixed max_speech_len canvas")
    add_model_args(ap)
    args = ap.parse_args(argv)
    device = device_of(ap, args.device)
    if args.long:
        if args.text is None or args.text_file:
            ap.error("--long takes --text (not --text_file)")
        if args.gt_length is not None:
            ap.error("--gt_length is per-utterance; incompatible with --long")
    elif args.text is None and not args.text_file:
        ap.error("one of --text / --text_file is required")
    with torch.no_grad():
        _run(args, device)
    print_launches(device)


def _run(args, device: torch.device) -> None:
    kw = dict(device=device, dtype=DTYPES[args.dtype])
    tokenizer = hub.build_audio_tokenizer(args.codec_model, args.hubert_model, **kw)
    s2a = hub.load_s2a(args.s2a_model, quantize=args.quantize_s2a or args.quantize, **kw)
    t2s = hub.load_t2s(args.t2s_model, quantize=args.quantize_t2s or args.quantize, **kw)
    sr = tokenizer.sample_rate

    # 1. tokenize the speaker prompt
    audio, prompt_sr = load_audio(args.speaker_prompt)
    wav = audio[0]
    if prompt_sr != sr:
        wav = resample_numpy(wav, prompt_sr, sr)
    prompt = tokenizer.compute_codes(wav[None])
    prompt_acoustic = prompt["acoustic_codes"]  # (1, Q, Tp)
    prompt_semantic = prompt["semantic_codes"]  # (1, Tp)

    # 2. the utterances
    if args.long:
        texts = split_text(args.text, args.max_chunk_chars
                           or default_chunk_chars(args.max_speech_len))
        print(f"long-form: {len(texts)} chunks")
    elif args.text_file:
        with open(args.text_file) as f:
            texts = [line.strip() for line in f if line.strip()]
    else:
        texts = [args.text]
    hop = tokenizer.downsample_factor

    def synthesize_group(group: list[str], group_idx: int) -> list[tuple[np.ndarray, int]]:
        """One batch of utterances: each one's waveform, trimmed to its
        length, and that length in frames. The text is padded to a multiple
        of 32 tokens."""
        gen = torch.Generator().manual_seed(args.seed + GROUP_SEED_STRIDE * group_idx)
        b = len(group)
        byte_seqs = [[c + 5 for c in t.encode("utf-8")] for t in group]
        lt = -(-max(len(s) for s in byte_seqs) // 32) * 32
        text_tokens = torch.tensor([s + [0] * (lt - len(s)) for s in byte_seqs], device=device)
        text_lengths = torch.tensor([len(s) for s in byte_seqs], device=device)
        gt = None
        if args.gt_length is not None:
            gt = torch.full((b,), args.gt_length, device=device)
        pa = prompt_acoustic.expand(b, *prompt_acoustic.shape[1:])
        ps = prompt_semantic.expand(b, *prompt_semantic.shape[1:])
        if args.one_shot:
            out = e2e_synthesize(
                t2s, s2a, text_tokens, text_lengths, pa, ps, gen,
                pred_iters=args.pred_iters, steps=args.s2a_steps,
                temperature=args.temperature, max_speech_len=args.max_speech_len,
                gt_length=gt,
            )
            audio_out, lengths = out["audio"], out["lengths"]
        else:
            # 3. text -> semantic tokens
            t2s_out = t2s_sample(
                t2s, text_tokens, text_lengths, gen, pred_iters=args.pred_iters,
                temperature=args.temperature, max_speech_len=args.max_speech_len,
                gt_length=gt,
            )
            lengths = t2s_out["lengths"]
            # the canvas bucketed; semantic_valid / valid_frames keep the
            # valid positions equal to an exact-size canvas's
            n_max = bucket_length(int(lengths.max()), args.length_bucket, args.max_speech_len)
            semantic_valid = torch.arange(n_max, device=device)[None, :] < lengths[:, None]
            # 4. semantic -> acoustic codes (the prompt broadcast)
            codes = s2a_sample(
                s2a, t2s_out["semantic_tokens"][:, :n_max], pa, ps, gen,
                steps=args.s2a_steps, temperature=args.temperature,
                semantic_valid=semantic_valid,
            )
            # 5. the masked decode
            audio_out = tokenizer.codec.decode_from_codes(codes, lengths)
        audio_out = audio_out[..., 0].float().cpu().numpy()
        lengths = lengths.cpu().numpy()
        return [(audio_out[i, : int(lengths[i]) * hop], int(lengths[i])) for i in range(b)]

    cap = max(1, args.long_batch) if args.long else len(texts)
    done: list[tuple[np.ndarray, int]] = []
    for gi, g in enumerate(range(0, len(texts), cap)):
        done.extend(synthesize_group(texts[g: g + cap], gi))
    waves = [w for w, _ in done]
    frames = [n for _, n in done]

    if args.long:
        joined = join_waveforms(waves, sr, crossfade_ms=args.crossfade_ms, gap_ms=args.gap_ms)
        save_wav(args.output, joined, sr)
        print(f"wrote {args.output}: {joined.shape[0] / sr:.2f}s ({len(texts)} chunks, "
              f"{joined.shape[0]} samples, chunk frames {frames})")
        return
    stem, ext = (args.output.rsplit(".", 1) + ["wav"])[:2]
    for i, wav_i in enumerate(waves):
        out_path = args.output if len(waves) == 1 else f"{stem}_{i}.{ext}"
        save_wav(out_path, wav_i, sr)
        print(f"wrote {out_path}: {wav_i.shape[0] / sr:.2f}s ({wav_i.shape[0]} samples, "
              f"{frames[i]} frames)")


if __name__ == "__main__":
    main()
