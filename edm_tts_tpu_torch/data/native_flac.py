"""ctypes binding of the repo's first-party FLAC decoder (``native/flac.cc``;
a copy of edm_tts_tpu/data/native_flac.py's decode path, pinned equal to it
in tests/test_torch_hub.py).

The shared library is built at first use with the host C++ compiler from
``native/flac.cc`` into ``edm_tts_tpu_torch/_build/``, keyed on a hash of
the source, so a checkout needs no prebuilt ``native/libedmflac.so``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from edm_tts_tpu_torch.data.audio_io import AudioInfo

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "flac.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lock = threading.Lock()
_lib = None


class _FlacInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("total_samples", ctypes.c_uint64),
    ]


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
        path = _BUILD_DIR / f"libedmflac_{digest}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp),
                            str(_SOURCE)], check=True)
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(path))
        lib.edmflac_info.restype = ctypes.c_int
        lib.edmflac_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_FlacInfo),
        ]
        lib.edmflac_decode.restype = ctypes.c_int64
        lib.edmflac_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return lib


def flac_info(path: str) -> AudioInfo:
    lib = _load_lib()
    with open(path, "rb") as f:
        data = f.read(65536)  # metadata fits in the head of the file
    info = _FlacInfo()
    rc = lib.edmflac_info(data, len(data), ctypes.byref(info))
    if rc != 0:
        # metadata larger than 64k (e.g. big seektables/pictures): read all
        with open(path, "rb") as f:
            data = f.read()
        rc = lib.edmflac_info(data, len(data), ctypes.byref(info))
        if rc != 0:
            raise ValueError(f"not a FLAC file: {path}")
    return AudioInfo(info.sample_rate, int(info.total_samples), info.channels)


def flac_read(
    path: str, frame_offset: int = 0, num_frames: int = -1
) -> tuple[np.ndarray, int]:
    """Decode a window; returns ((C, T) float32 in [-1, 1], sample_rate)."""
    lib = _load_lib()
    with open(path, "rb") as f:
        data = f.read()
    info = _FlacInfo()
    if lib.edmflac_info(data, len(data), ctypes.byref(info)) != 0:
        raise ValueError(f"not a FLAC file: {path}")
    total = int(info.total_samples)
    if num_frames < 0:
        num_frames = total - frame_offset
    num_frames = max(min(num_frames, total - frame_offset), 0)
    out = np.zeros(num_frames * info.channels, dtype=np.float32)
    n = lib.edmflac_decode(
        data, len(data), frame_offset, num_frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n < 0:
        raise ValueError(f"FLAC decode error: {path}")
    audio = out[: n * info.channels].reshape(-1, info.channels).T
    return np.ascontiguousarray(audio), int(info.sample_rate)
