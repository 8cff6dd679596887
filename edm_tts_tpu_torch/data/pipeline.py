"""Streaming helpers of the input pipelines (copies of ``shard_for_process``,
``shuffle_buffer``, ``load_audio_segments`` and ``crop_code_example`` in
edm_tts_tpu/data/pipeline.py, whose module imports jax through its audio
helpers; pinned equal by tests/test_torch_train_data.py and
tests/test_torch_preprocess.py).
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator

import numpy as np

from edm_tts_tpu_torch.data.audio_io import load_audio
from edm_tts_tpu_torch.ops.resample import resample_numpy


def shard_for_process(
    examples: Iterable, process_index: int, process_count: int
) -> Iterator:
    for i, ex in enumerate(examples):
        if i % process_count == process_index:
            yield ex


def shuffle_buffer(examples: Iterable, buffer_size: int, seed: int = 0) -> Iterator:
    rng = random.Random(seed)
    buf = []
    for ex in examples:
        if len(buf) < buffer_size:
            buf.append(ex)
            continue
        j = rng.randrange(buffer_size)
        yield buf[j]
        buf[j] = ex
    rng.shuffle(buf)
    yield from buf


def load_audio_segments(
    example: dict, target_sr: int, segment_seconds: float | None
) -> Iterator[dict]:
    """Load one manifest window, pad, resample, split into fixed segments,
    drop the short tail (reference load_audio_segments:61-96).

    If the example carries a ``_audio``/``_sr`` pair (attached by the native
    prefetcher, data/native_prefetch.py), the decode is already done on the
    C++ thread pool and no file IO happens here."""
    if "_audio" in example:
        audio, sr = example["_audio"], example["_sr"]
    else:
        audio, sr = load_audio(
            example["file"], example.get("offset", 0),
            example.get("num_frames", -1),
        )
        audio = audio[0]  # mono
    padding = example.get("padding", 0)
    if padding > 0:
        audio = np.pad(audio, (0, padding))
    if sr != target_sr:
        audio = resample_numpy(audio, sr, target_sr)
    if segment_seconds is None:
        yield {"id": example["id"] + "-0", "audio": audio.astype(np.float32)}
        return
    seg = int(segment_seconds * target_sr)
    n = len(audio) // seg
    for j in range(n):
        yield {
            "id": f"{example['id']}-{j}",
            "audio": audio[j * seg : (j + 1) * seg].astype(np.float32),
        }


def crop_code_example(
    example: dict,
    segment_frames: int,
    rng: random.Random,
    random_segment: bool = True,
) -> dict | None:
    """Aligned random crop of acoustic+semantic token streams; None if too
    short."""
    a = example["acoustic_tokens"]  # (Q, T)
    s = example["semantic_tokens"]  # (T,)
    t = min(a.shape[-1], s.shape[-1])
    if t < segment_frames:
        return None
    start = rng.randint(0, t - segment_frames) if random_segment else 0
    return {
        "acoustic_tokens": a[:, start : start + segment_frames],
        "semantic_tokens": s[start : start + segment_frames],
    }
