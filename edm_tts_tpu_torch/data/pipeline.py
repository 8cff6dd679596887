"""Streaming helpers of the s2a input pipeline (copies of
``shuffle_buffer`` and ``crop_code_example`` in
edm_tts_tpu/data/pipeline.py, whose module imports jax through its audio
helpers; pinned equal by tests/test_torch_train_data.py).
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator


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
