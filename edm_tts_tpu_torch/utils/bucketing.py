"""Shape bucketing (copy of edm_tts_tpu/utils/bucketing.py).

The serving engine rounds text length, canvas length and batch size up to
a few buckets and masks the padding, so that requests of nearby sizes run
the same shapes. Pinned equal to the original by
tests/test_torch_serving.py.
"""

from __future__ import annotations


def bucket_length(n: int, multiple: int, cap: int | None = None) -> int:
    """Round ``n`` up to a multiple (cap at ``cap``) so nearby lengths share
    one canvas."""
    n = -(-max(n, 1) // multiple) * multiple
    return min(n, cap) if cap else n


def bucket_batch(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= n (buckets need not be sorted); n must fit."""
    fits = [b for b in buckets if b >= n]
    if not fits:
        raise ValueError(f"batch {n} exceeds largest bucket {max(buckets)}")
    return min(fits)
