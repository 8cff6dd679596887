"""Text normalization for LibriHeavy transcripts (a copy of
edm_tts_tpu/data/text_norm.py, pinned equal by tests/test_torch_preprocess.py).

Behavior parity with the reference's two normalizers:

- ``normalize_text``: map curly quotes to ASCII, uppercase alphanumerics +
  apostrophe, everything else to space, collapse whitespace ("no-punc" text);
- ``clean_text``: translate full-width/CJK punctuation to ASCII equivalents,
  strip ("punc" text, the one used for training byte sequences).
"""

from __future__ import annotations

_KEEP = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789'")
_PUNC_TABLE = str.maketrans("’‘，。；？！（）：-《》、“”【】", "'',.;?!(): <>/\"\"[]")


def normalize_text(s: str) -> str:
    s = s.replace("‘", "'").replace("’", "'")
    chars = [c.upper() if c in _KEEP else " " for c in s]
    return " ".join("".join(chars).split()).strip()


def clean_text(s: str) -> str:
    return s.translate(_PUNC_TABLE).strip()


def text_to_bytes(s: str) -> list[int]:
    """UTF-8 byte token ids (0..255); the t2s text vocabulary."""
    return list(s.encode("utf-8"))
