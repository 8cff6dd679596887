"""ctypes binding of the native threaded audio prefetcher
(``native/prefetch.cc``): the data-loader-worker analog of the reference's
``DataLoader(num_workers=32)``, a copy of edm_tts_tpu/data/native_prefetch.py
(``AudioPrefetcher``, ``prefetch_audio_windows`` and ``prefetch_manifest``
pinned equal by tests/test_torch_preprocess.py).

``prefetch_audio_windows`` maps an iterable of (path, frame_offset,
num_frames) windows to decoded float32 waveforms, keeping up to
``max_inflight`` decodes running on a C++ thread pool ahead of the
consumer; delivery order always matches submission order (deterministic
pipelines regardless of thread scheduling).

The shared library is built at first use with the host C++ compiler from
``native/prefetch.cc`` and ``native/flac.cc`` (whose decoder the pool runs)
into ``edm_tts_tpu_torch/_build/``, keyed on a hash of the two sources, as
``data/native_flac.py`` builds its decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

_SOURCES = tuple(Path(__file__).resolve().parents[2] / "native" / name
                 for name in ("prefetch.cc", "flac.cc"))
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib = None


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for src in _SOURCES:
            h.update(src.read_bytes())
        path = _BUILD_DIR / f"libedmprefetch_{h.hexdigest()[:16]}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp),
                            *map(str, _SOURCES), "-lpthread"], check=True)
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        _lib = ctypes.CDLL(str(path))
        return _lib


def _bind(lib):
    if getattr(lib, "_edmpf_bound", False):
        return lib
    lib.edmpf_create.restype = ctypes.c_void_p
    lib.edmpf_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.edmpf_submit.restype = ctypes.c_int64
    lib.edmpf_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.edmpf_next.restype = ctypes.c_int64
    lib.edmpf_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.edmpf_destroy.restype = None
    lib.edmpf_destroy.argtypes = [ctypes.c_void_p]
    lib._edmpf_bound = True
    return lib


class AudioPrefetcher:
    """Bounded thread-pool FLAC window decoder (submission-order delivery)."""

    def __init__(self, n_threads: int = 4, max_inflight: int = 32,
                 max_seconds: float = 70.0, max_rate: int = 48000):
        self._lib = _bind(_load_lib())
        self._h = self._lib.edmpf_create(n_threads, max_inflight)
        self._max_samples = int(max_seconds * max_rate)
        self._buf = np.empty(self._max_samples * 8, np.float32)
        self._outstanding = 0

    def submit(self, path: str, frame_offset: int = 0,
               num_frames: int = -1) -> None:
        if self._h is None:
            raise RuntimeError("prefetcher is closed")
        r = self._lib.edmpf_submit(
            self._h, str(path).encode(), frame_offset, num_frames
        )
        if r < 0:
            raise RuntimeError("prefetcher is shut down")
        self._outstanding += 1

    def next(self) -> tuple[np.ndarray, int]:
        """Blocks for the oldest submitted window: (waveform (T,), sr)."""
        if self._h is None:
            raise RuntimeError("prefetcher is closed")
        if self._outstanding == 0:
            raise IndexError("no outstanding prefetch jobs")
        sr = ctypes.c_uint32(0)
        ch = ctypes.c_uint32(0)
        # capacity is the buffer size in TOTAL interleaved floats (the C side
        # checks n * channels against it before the memcpy)
        n = self._lib.edmpf_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.size, ctypes.byref(sr), ctypes.byref(ch),
        )
        self._outstanding -= 1
        if n == -3:
            raise RuntimeError(
                "prefetched window exceeds the host buffer "
                f"({self._buf.size} floats); raise max_seconds"
            )
        if n < 0:
            raise RuntimeError("native prefetch decode failed")
        wav = self._buf[: n * ch.value].reshape(n, ch.value)
        # channel 0, matching the sync path (pipeline.load_audio_segments
        # takes audio[0] of flac_read's (C, T))
        return np.array(wav[:, 0]), int(sr.value)

    def close(self) -> None:
        if self._h is not None:
            self._lib.edmpf_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def prefetch_audio_windows(
    windows: Iterable[tuple[str, int, int]],
    n_threads: int = 4,
    max_inflight: int = 32,
) -> Iterator[tuple[np.ndarray, int]]:
    """Decode (path, frame_offset, num_frames) windows ahead of the consumer.

    Yields (mono float32 waveform, sample_rate) in input order. Windows are
    submitted up to ``max_inflight`` ahead; C++ workers decode concurrently
    with both the Python consumer and the device step.
    """
    with AudioPrefetcher(n_threads, max_inflight) as pf:
        it = iter(windows)
        # prime the queue
        for _ in range(max_inflight):
            try:
                path, off, n = next(it)
            except StopIteration:
                break
            pf.submit(path, off, n)
        while pf._outstanding:
            out = pf.next()
            try:
                path, off, n = next(it)
                pf.submit(path, off, n)
            except StopIteration:
                pass
            yield out


def prefetch_manifest(
    examples: Iterable[dict],
    n_threads: int = 2,
    max_inflight: int = 16,
) -> Iterator[dict]:
    """Attach prefetched audio to manifest windows (``_audio``/``_sr``).

    FLAC windows are decoded ahead on the C++ pool; non-FLAC examples pass
    through untouched (the sync loader handles them). Order is preserved.
    """
    with AudioPrefetcher(n_threads, max_inflight) as pf:
        # passthrough (non-FLAC) slots are tracked by the absence of the
        # "_prefetched" flag; every element is a dict
        pending: list[dict] = []

        def drain_one():
            ex = pending.pop(0)
            if ex.pop("_prefetched", False):
                audio, sr = pf.next()
                ex["_audio"], ex["_sr"] = audio, sr
            return ex

        for ex in examples:
            ex = dict(ex)
            if str(ex.get("file", "")).endswith(".flac"):
                pf.submit(ex["file"], ex.get("offset", 0),
                          ex.get("num_frames", -1))
                ex["_prefetched"] = True
            pending.append(ex)
            if len(pending) >= max_inflight:
                yield drain_one()
        while pending:
            yield drain_one()
