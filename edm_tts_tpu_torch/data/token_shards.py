"""Token shard storage (copy of edm_tts_tpu/data/token_shards.py; pinned
equal by tests/test_torch_train_data.py).

Aligned acoustic + semantic (+ text) token records: one flat little-endian
int16 binary per shard plus a JSON index (memory-mapped reads, no
pickle), and a reader for the reference's ``{rank}_{idx}.pt`` shards of
``id -> {acoustic_codes (12, T), semantic_codes (T, 1)}``.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np


class TokenShardWriter:
    """Writes ``shard_{rank}_{idx}.bin`` + ``.json`` index files."""

    def __init__(self, output_dir: str, rank: int = 0, items_per_shard: int = 1000):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.rank = rank
        self.items_per_shard = items_per_shard
        self._idx = 0
        self._reset()

    def _reset(self):
        self._buf: list[bytes] = []
        self._index: list[dict] = []
        self._offset = 0

    def add(
        self,
        item_id: str,
        acoustic_codes: np.ndarray,
        semantic_codes: np.ndarray,
        text: str | None = None,
        text_bytes: list[int] | None = None,
        no_punc_text: str | None = None,
        no_punc_text_bytes: list[int] | None = None,
    ):
        a = np.ascontiguousarray(acoustic_codes, dtype=np.int16)
        s = np.ascontiguousarray(semantic_codes, dtype=np.int16).reshape(-1)
        rec = {
            "id": item_id,
            "a_off": self._offset,
            "a_shape": list(a.shape),
        }
        self._buf.append(a.tobytes())
        self._offset += a.size
        rec["s_off"] = self._offset
        rec["s_len"] = int(s.size)
        self._buf.append(s.tobytes())
        self._offset += s.size
        if text is not None:
            rec["text"] = text
        if text_bytes is not None:
            rec["text_bytes"] = list(map(int, text_bytes))
        if no_punc_text is not None:
            rec["no_punc_text"] = no_punc_text
        if no_punc_text_bytes is not None:
            rec["no_punc_text_bytes"] = list(map(int, no_punc_text_bytes))
        self._index.append(rec)
        if len(self._index) >= self.items_per_shard:
            self.flush()

    def flush(self):
        if not self._index:
            return
        base = os.path.join(
            self.output_dir, f"shard_{self.rank}_{self._idx:05d}"
        )
        with open(base + ".bin", "wb") as f:
            f.write(b"".join(self._buf))
        with open(base + ".json", "w") as f:
            json.dump(self._index, f)
        self._idx += 1
        self._reset()

    def close(self):
        self.flush()


def iter_token_shards(shard_dir: str) -> Iterator[dict]:
    """Yield {id, acoustic_codes (Q,T) int, semantic_codes (T,) int, text?}
    from native shards (memory-mapped)."""
    import glob

    for base in sorted(glob.glob(os.path.join(shard_dir, "shard_*.json"))):
        with open(base) as f:
            index = json.load(f)
        data = np.memmap(base[:-5] + ".bin", dtype=np.int16, mode="r")
        for rec in index:
            q, t = rec["a_shape"]
            a = np.asarray(
                data[rec["a_off"] : rec["a_off"] + q * t]
            ).reshape(q, t)
            s = np.asarray(data[rec["s_off"] : rec["s_off"] + rec["s_len"]])
            out = {
                "id": rec["id"],
                "acoustic_tokens": a.astype(np.int32),
                "semantic_tokens": s.astype(np.int32),
            }
            if "text" in rec:
                out["transcription"] = rec["text"]
            if "text_bytes" in rec:
                out["transcription_bytes"] = rec["text_bytes"]
            if "no_punc_text" in rec:
                out["no_punc_transcription"] = rec["no_punc_text"]
            if "no_punc_text_bytes" in rec:
                out["no_punc_transcription_bytes"] = rec["no_punc_text_bytes"]
            yield out


def iter_reference_pt_shards(shard_dir: str) -> Iterator[dict]:
    """Compatibility reader for the reference's ``*.pt`` token shards
    (codes_dataset.py:45-63 schema; torch-cpu unpickling)."""
    import glob

    import torch

    for path in sorted(glob.glob(os.path.join(shard_dir, "*.pt"))):
        blob = torch.load(path, map_location="cpu", weights_only=False)
        for item_id, rec in blob.items():
            a = np.asarray(rec["acoustic_codes"], dtype=np.int32)
            s = np.asarray(rec["semantic_codes"], dtype=np.int32).reshape(-1)
            out = {"id": item_id, "acoustic_tokens": a, "semantic_tokens": s}
            if "transcription" in rec:
                out["transcription"] = rec["transcription"]
            if "transcription_bytes" in rec:
                out["transcription_bytes"] = list(
                    np.asarray(rec["transcription_bytes"]).reshape(-1)
                )
            yield out
