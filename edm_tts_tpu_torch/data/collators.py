"""Batch collators (copies of ``collate_codec_audio``, ``collate_s2a``,
``t2s_filter``, ``collate_t2s``, ``length_bucketed`` and
``collate_dump_batch`` in edm_tts_tpu/data/collators.py, whose module
imports the t2s config and with it jax; pinned equal by
tests/test_torch_train_data.py, tests/test_torch_t2s_train.py,
tests/test_torch_preprocess.py and tests/test_torch_codec_train.py)."""

from __future__ import annotations

import random
from typing import Iterable, Iterator, Sequence

import numpy as np

from edm_tts_tpu_torch.models.t2s.config import SPECIAL_TOKENS


def collate_codec_audio(segments: Sequence[np.ndarray]) -> np.ndarray:
    """Stack equal-length audio segments -> (B, T, 1)."""
    return np.stack(segments, axis=0)[..., None].astype(np.float32)


def collate_s2a(examples: Sequence[dict]) -> dict:
    """Stack aligned code crops -> {acoustic_tokens (B,Q,T), semantic_tokens (B,T)}."""
    return {
        "acoustic_tokens": np.stack(
            [e["acoustic_tokens"] for e in examples]
        ).astype(np.int32),
        "semantic_tokens": np.stack(
            [e["semantic_tokens"] for e in examples]
        ).astype(np.int32),
    }


def t2s_filter(example: dict, min_len: int = 20, max_len: int = 1250) -> bool:
    """Reference filter_fn (run_text_to_semantic_training.py:195-204):
    20 < semantic_len < 1250 and semantic_len > text_len."""
    sem_len = len(example["semantic_tokens"])
    text_len = len(example["transcription_bytes"])
    return min_len < sem_len < max_len and sem_len > text_len


def collate_t2s(
    examples: Sequence[dict],
    *,
    num_special: int = 5,
    text_vocab: int = 256,
    pad_to_multiple: int = 64,
) -> dict:
    """Build the joint ``[TEXT] bytes [SEP] [SPEECH] semantic [SEP]``
    batch with all masks the static-shape t2s forward needs.

    Token shifts: text bytes + num_special; semantic + num_special +
    text_vocab (reference collator :163-183).
    """
    tok = SPECIAL_TOKENS
    seqs, speech_spans, texts = [], [], []
    for ex in examples:
        text_b = [b + num_special for b in ex["transcription_bytes"]]
        sem = [int(s) + num_special + text_vocab for s in ex["semantic_tokens"]]
        seq = (
            [tok["text"]] + text_b + [tok["sep"]] + [tok["speech"]] + sem + [tok["sep"]]
        )
        speech_start = 1 + len(text_b) + 2  # first semantic position
        seqs.append(seq)
        speech_spans.append((speech_start, len(sem)))
        texts.append(text_b)

    def rnd_up(n):
        return ((n + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple

    max_len = rnd_up(max(len(s) for s in seqs))
    max_text = rnd_up(max(len(t) for t in texts))
    b = len(seqs)
    input_ids = np.full((b, max_len), tok["pad"], np.int32)
    attention = np.zeros((b, max_len), bool)
    speech_mask = np.zeros((b, max_len), bool)
    text_ids = np.full((b, max_text), tok["pad"], np.int32)
    text_attention = np.zeros((b, max_text), bool)
    speech_lengths = np.zeros((b,), np.float32)
    for i, (seq, (start, slen), text_b) in enumerate(
        zip(seqs, speech_spans, texts)
    ):
        input_ids[i, : len(seq)] = seq
        attention[i, : len(seq)] = True
        speech_mask[i, start : start + slen] = True
        text_ids[i, : len(text_b)] = text_b
        text_attention[i, : len(text_b)] = True
        speech_lengths[i] = slen
    return {
        "input_ids": input_ids,
        "attention_mask": attention,
        "speech_mask": speech_mask,
        "text_ids": text_ids,
        "text_attention_mask": text_attention,
        "speech_lengths": speech_lengths,
    }


def length_bucketed(
    examples: Iterable[dict],
    batch_size: int,
    *,
    length_key=lambda ex: len(ex["semantic_tokens"]),
    bucket_count: int = 8,
    pool_size: int = 2048,
    seed: int = 0,
) -> Iterator[list]:
    """Group similar-length examples (replaces HF ``group_by_length`` with a
    jit-cache-friendly bucketing: at most ``bucket_count`` padded shapes)."""
    rng = random.Random(seed)
    pool: list[dict] = []
    for ex in examples:
        pool.append(ex)
        if len(pool) >= pool_size:
            pool.sort(key=length_key)
            batches = [
                pool[i : i + batch_size]
                for i in range(0, len(pool) - batch_size + 1, batch_size)
            ]
            rng.shuffle(batches)
            yield from batches
            pool = pool[len(batches) * batch_size :]
    while len(pool) >= batch_size:
        yield pool[:batch_size]
        pool = pool[batch_size:]


def collate_dump_batch(
    windows: Sequence[dict], tokenizer, target_sr: int = 16000
) -> dict:
    """The dump_tokens collator (reference dump_tokens.py:93-134): load the
    audio windows, apply the alignment pad hack, volume-normalize a copy for
    the codec, build attention masks for HuBERT, record code lengths."""
    from edm_tts_tpu_torch.data.pipeline import load_audio_segments
    from edm_tts_tpu_torch.ops.loudness import normalize_loudness

    audios, ids = [], []
    for w in windows:
        segs = list(load_audio_segments(w, target_sr, None))
        audios.append(segs[0]["audio"])
        ids.append(w["id"])
    lengths = np.array([len(a) for a in audios])
    padded = [tokenizer.pad(a[None])[0] for a in audios]
    padded_lengths = np.array([len(a) for a in padded])
    max_len = int(padded_lengths.max())
    batch = np.zeros((len(padded), max_len), np.float32)
    mask = np.zeros((len(padded), max_len), np.int32)
    for i, a in enumerate(padded):
        batch[i, : len(a)] = a
        mask[i, : len(a)] = 1
    normalized = np.stack(
        [
            np.pad(
                normalize_loudness(a[None], target_sr, -16.0)[0][0],
                (0, max_len - len(a)),
            )
            for a in padded
        ]
    )
    code_lengths = tokenizer.get_code_lengths(padded_lengths)
    return {
        "ids": ids,
        "normalized_audio": normalized,
        "padded_audio": batch,
        "attention_mask": mask,
        "code_lengths": code_lengths,
        "transcriptions": [w.get("transcription") for w in windows],
        "transcription_bytes": [w.get("transcription_bytes") for w in windows],
        "no_punc_transcriptions": [
            w.get("no_punc_transcription") for w in windows
        ],
        "no_punc_transcription_bytes": [
            w.get("no_punc_transcription_bytes") for w in windows
        ],
    }
