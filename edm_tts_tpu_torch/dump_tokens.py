"""Offline tokenization: aligned acoustic + semantic token shards for
LibriLight, LibriHeavy or LibriSpeech (the port's counterpart of
utility_scripts/dump_tokens.py).

    python -m edm_tts_tpu_torch.dump_tokens --dataset librilight --data_dir D \
        --subset small --output_dir data/codes --codec_model CODEC_DIR \
        --hubert_model HF_DIR [--batch_size 8 --segment_seconds 60 \
        --items_per_shard 1000 --max_items -1 --dtype bfloat16 \
        --prefetch_threads 2] [--device cuda|cpu]

The same steps as the JAX tool: the manifest (LibriLight in
``--segment_seconds`` windows), sharded per process
(``shard_for_process``; rank and world from ``torch.distributed`` when it is
initialized, else 0 and 1), FLAC windows decoded ahead on the native thread
pool (``--prefetch_threads``, 0 for synchronous loads), batches of
``--batch_size`` collated by ``collate_dump_batch`` (the alignment pad, a
loudness-normalized copy for the codec, HuBERT's attention mask, the code
lengths), ``AudioTokenizer.compute_codes_batch`` on the device, each item's
codes trimmed to its code length and written by ``TokenShardWriter`` as
``shard_{rank}_{idx}`` files (int16 codes, the transcriptions when the
manifest has them) that the trainers read.

The models come from a codec directory and a local HF HuBERT directory with
its centroids (``utils/hub.py``), in ``--dtype``. On the card (``--device
cuda``, the default; without a card it is an error) a bf16 run takes K1 for
the codec encoder's residual units and K3 for HuBERT's attention, an f32 run
the codec's composition and K3's f32 kernel with TF32 off; it prints its
kernel launches last.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from edm_tts_tpu_torch.data.collators import collate_dump_batch
from edm_tts_tpu_torch.data.manifests import (
    libriheavy_manifest,
    librilight_manifest,
    librispeech_manifest,
)
from edm_tts_tpu_torch.data.pipeline import shard_for_process
from edm_tts_tpu_torch.data.token_shards import TokenShardWriter
from edm_tts_tpu_torch.inference import DTYPES, device_of, print_launches
from edm_tts_tpu_torch.utils.hub import build_audio_tokenizer
from edm_tts_tpu_torch.utils.logging import setup_logging


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["librilight", "libriheavy", "librispeech"],
                    required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--subset", default="small")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--codec_model", required=True)
    ap.add_argument("--hubert_model", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--segment_seconds", type=float, default=60.0,
                    help="librilight window size (reference: 60 s)")
    ap.add_argument("--items_per_shard", type=int, default=1000)
    ap.add_argument("--max_items", type=int, default=-1)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--prefetch_threads", type=int, default=2,
                    help="native C++ audio-decode threads running ahead of the device "
                         "(0 = synchronous loads)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the card, an error without one) or 'cpu'")
    args = ap.parse_args(argv)
    device = device_of(ap, args.device)
    setup_logging()
    tokenizer = build_audio_tokenizer(args.codec_model, args.hubert_model, device=device,
                                      dtype=DTYPES[args.dtype])

    if args.dataset == "librilight":
        manifest = librilight_manifest(args.data_dir, args.subset,
                                       segment_seconds=args.segment_seconds)
    elif args.dataset == "libriheavy":
        manifest = libriheavy_manifest(args.data_dir, args.subset)
    else:
        manifest = librispeech_manifest(args.data_dir, args.subset)

    dist = torch.distributed.is_available() and torch.distributed.is_initialized()
    rank, world = (torch.distributed.get_rank(), torch.distributed.get_world_size()) \
        if dist else (0, 1)
    writer = TokenShardWriter(args.output_dir, rank, args.items_per_shard)

    stream = shard_for_process(manifest, rank, world)
    if args.prefetch_threads > 0:
        from edm_tts_tpu_torch.data.native_prefetch import prefetch_manifest

        stream = prefetch_manifest(stream, n_threads=args.prefetch_threads)

    buf = []
    n_done = 0
    t0 = time.time()
    for window in stream:
        buf.append(window)
        if len(buf) < args.batch_size:
            continue
        n_done += _process(buf, tokenizer, writer)
        buf = []
        if n_done and n_done % 100 == 0:
            rate = n_done / (time.time() - t0)
            print(f"[rank {rank}] {n_done} items ({rate:.1f}/s)", flush=True)
        if 0 < args.max_items <= n_done:
            break
    if buf:
        n_done += _process(buf, tokenizer, writer)
    writer.close()
    print(f"[rank {rank}] done: {n_done} items in {time.time() - t0:.1f}s", flush=True)
    print_launches(device)


def _process(windows, tokenizer, writer) -> int:
    batch = collate_dump_batch(windows, tokenizer)
    out = tokenizer.compute_codes_batch(batch["normalized_audio"], batch["padded_audio"],
                                        batch["attention_mask"])
    acoustic = out["acoustic_codes"].cpu().numpy()
    semantic = out["semantic_codes"].cpu().numpy()
    for i, item_id in enumerate(batch["ids"]):
        n = int(batch["code_lengths"][i])
        writer.add(
            item_id,
            acoustic[i, :, :n].astype(np.int16),
            semantic[i, :n].astype(np.int16),
            text=batch["transcriptions"][i],
            text_bytes=batch["transcription_bytes"][i],
            no_punc_text=batch["no_punc_transcriptions"][i],
            no_punc_text_bytes=batch["no_punc_transcription_bytes"][i],
        )
    return len(batch["ids"])


if __name__ == "__main__":
    main()
