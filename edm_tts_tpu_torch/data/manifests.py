"""Dataset manifest builders: LibriSpeech, LibriLight, LibriHeavy (a copy of
edm_tts_tpu/data/manifests.py, pinned equal by tests/test_torch_preprocess.py).

Plain-python generators with the same example schemas and semantics as the
reference's HF ``datasets`` builder scripts:

- LibriSpeech: glob ``*.flac`` + ``*.trans.txt`` under the split dirs,
  yield {id, file, transcription, no_punc_transcription and their UTF-8
  bytes};
- LibriLight: glob FLACs of small/medium/large, segment each file into 60 s
  non-overlapping windows at manifest time using header-only probing,
  yield {id, file, sample_rate, offset, num_frames, padding}; the last
  window is padded up to 60 s;
- LibriHeavy: read chunked ``*.jsonl.gz`` cut manifests, resolve flac path,
  start/duration -> samples (ms-floored), normalized + cleaned text with
  UTF-8 byte lists.

Iterators are cheap and picklable; sharding for multi-process token dumping
is ``manifest[rank::world_size]`` (``data.pipeline.shard_for_process``).
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
from typing import Iterator

from edm_tts_tpu_torch.data.audio_io import audio_info
from edm_tts_tpu_torch.data.text_norm import clean_text, normalize_text

LIBRISPEECH_SPLITS = {
    "clean": ["train-clean-100", "train-clean-360"],
    "other": ["train-other-500"],
    "full": ["train-clean-100", "train-clean-360", "train-other-500"],
    "dev": ["dev-clean", "dev-other"],
    "test": ["test-clean", "test-other"],
}

LIBRILIGHT_SUBSETS = {
    "small": ["small"],
    "medium": ["medium"],
    "large": ["large"],
    "all": ["small", "medium", "large"],
}


def librispeech_manifest(data_dir: str, subset: str = "clean") -> Iterator[dict]:
    """Yield {id, file, transcription} for each utterance."""
    splits = LIBRISPEECH_SPLITS[subset] if subset in LIBRISPEECH_SPLITS else [subset]
    for split in splits:
        root = os.path.join(data_dir, "LibriSpeech", split)
        for trans_path in sorted(
            glob.glob(os.path.join(root, "*", "*", "*.trans.txt"))
        ):
            folder = os.path.dirname(trans_path)
            with open(trans_path) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    # same normalized-text schema as libriheavy_manifest so
                    # dumped shards feed t2s training (clean/no-punc forms +
                    # utf-8 bytes; reference text_speech_codes_dataset.py
                    # reads both byte streams)
                    punc = clean_text(text)
                    no_punc = normalize_text(text)
                    yield {
                        "id": utt_id,
                        "file": os.path.join(folder, utt_id + ".flac"),
                        "transcription": punc,
                        "no_punc_transcription": no_punc,
                        "transcription_bytes": list(punc.encode("utf-8")),
                        "no_punc_transcription_bytes": list(
                            no_punc.encode("utf-8")
                        ),
                    }


def librilight_manifest(
    data_dir: str,
    subset: str = "all",
    segment_seconds: float = 60.0,
) -> Iterator[dict]:
    """Yield 60 s windows {id, file, sample_rate, offset, num_frames, padding}."""
    for sub in LIBRILIGHT_SUBSETS[subset]:
        for path in sorted(
            glob.glob(os.path.join(data_dir, sub, "**", "*.flac"), recursive=True)
        ):
            info = audio_info(path)
            seg = int(segment_seconds * info.sample_rate)
            total = info.num_frames
            n_segments = max(math.ceil(total / seg), 1)
            base = os.path.splitext(os.path.basename(path))[0]
            for i in range(n_segments):
                offset = i * seg
                num = min(seg, total - offset)
                yield {
                    "id": f"{base}-{i}",
                    "file": path,
                    "sample_rate": info.sample_rate,
                    "offset": offset,
                    "num_frames": num,
                    "padding": seg - num,
                }


def libriheavy_manifest(
    base_data_dir: str, subset: str = "all"
) -> Iterator[dict]:
    """Yield cut examples from chunked jsonl.gz manifests."""
    subsets = ["small", "medium", "large"] if subset == "all" else [subset]
    files: list[str] = []
    for sub in subsets:
        files += sorted(
            glob.glob(os.path.join(base_data_dir, "libriheavy", sub, "*.jsonl.gz"))
        )
    for mf in files:
        with gzip.open(mf, "rt", encoding="utf-8") as f:
            for line in f:
                cut = json.loads(line)
                start = math.floor(1000 * cut["start"]) / 1000
                duration = math.floor(1000 * cut["duration"]) / 1000
                sr = cut["recording"]["sampling_rate"]
                text = cut["supervisions"][0]["custom"]["texts"][0]
                punc = clean_text(text)
                no_punc = normalize_text(text)
                punc_bytes = list(punc.encode("utf-8"))
                no_punc_bytes = list(no_punc.encode("utf-8"))
                if not punc_bytes or not no_punc_bytes:
                    continue
                yield {
                    "id": cut["id"],
                    "file": os.path.join(
                        base_data_dir, cut["recording"]["id"] + ".flac"
                    ),
                    "sample_rate": sr,
                    "offset": int(start * sr),
                    "num_frames": int(duration * sr),
                    "transcription": punc,
                    "no_punc_transcription": no_punc,
                    "transcription_bytes": punc_bytes,
                    "no_punc_transcription_bytes": no_punc_bytes,
                }


def chunk_jsonl_gz(input_path: str, output_dir: str, lines_per_chunk: int = 100_000):
    """Split a large jsonl.gz manifest into gzip chunks (the reference's
    utility_scripts/chunk_libriheavy_manifests tool)."""
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(input_path).replace(".jsonl.gz", "")
    out = None
    idx = 0
    count = 0
    with gzip.open(input_path, "rt", encoding="utf-8") as f:
        for line in f:
            if out is None:
                out = gzip.open(
                    os.path.join(output_dir, f"{base}.{idx:05d}.jsonl.gz"),
                    "wt",
                    encoding="utf-8",
                )
            out.write(line)
            count += 1
            if count >= lines_per_chunk:
                out.close()
                out = None
                idx += 1
                count = 0
    if out is not None:
        out.close()
    return idx + 1
