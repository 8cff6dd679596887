"""Full f32 products on the card where an argmin reads them.

PyTorch may run an f32 matmul (``torch.backends.cuda.matmul.allow_tf32``)
or an f32 convolution (``torch.backends.cudnn.allow_tf32``, on by default)
in TF32, which keeps ~3 decimal digits. The RVQ's and the k-means
assignment's nearest-vector argmins and the resampler take their f32
products exact: ``exact_f32`` turns both switches off for its block. The
switches are process-wide and the server tokenizes on its handler threads,
so the blocks share one count under a lock: the first to enter turns off
the switches it finds on, and the last to leave turns those back on. A
caller that keeps TF32 off (chip_smoke.py does) never has them written.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_holders = 0
_turned_off: list = []


@contextlib.contextmanager
def exact_f32():
    """Run the block with TF32 off for matmuls and cuDNN convolutions."""
    global _holders, _turned_off
    with _lock:
        if _holders == 0:
            _turned_off = [s for s in (torch.backends.cuda.matmul, torch.backends.cudnn)
                           if s.allow_tf32]
            for s in _turned_off:
                s.allow_tf32 = False
        _holders += 1
    try:
        yield
    finally:
        with _lock:
            _holders -= 1
            if _holders == 0:
                for s in _turned_off:
                    s.allow_tf32 = True
                _turned_off = []
