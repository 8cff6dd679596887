"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are ``edm_tts_tpu_torch/csrc/*.cu`` (plain C entry points, no
PyTorch headers, so one nvcc call takes seconds). The shared library is
built at first use into ``edm_tts_tpu_torch/_build/``, keyed on a hash of
the sources and the flags, so a checkout builds everything it needs from
its own files and a changed source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's kernels "
            "are built on a machine with the CUDA toolkit"
        )
    return str(path)


def _run(cmds: list[list[str]]) -> None:
    """Start every command at once and wait for all; raise with the stderr
    of the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library; returns its path.

    Each source compiles in its own nvcc process, all started together, and
    one more links the objects. Raises RuntimeError with nvcc's stderr when
    the build fails.
    """
    out = BUILD_DIR / f"libedm_kernels_{_digest()}.so"
    if out.exists():
        return out
    return build_sources(_sources(), out)


def build_sources(sources: list[Path], out: Path) -> Path:
    """Compile ``sources`` (each in its own nvcc process, all at once) and
    link them into the shared library ``out``; returns ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.parent / f"{tag}.tmp.so"
    nvcc = _nvcc()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.edm_resunit.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.edm_tconv_phase.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.edm_attention.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.edm_attention_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.edm_int8_dense.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.edm_attn_variant.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.edm_attention_f32.argtypes = [ptr] * 6 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.edm_int8_dense_f32.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.edm_attention_bwd_f32.argtypes = [ptr] * 10 + [i32] * 5 + [ctypes.c_float, ptr]
    for fn in (lib.edm_resunit, lib.edm_tconv_phase, lib.edm_attention,
               lib.edm_attention_bwd, lib.edm_int8_dense, lib.edm_attn_variant,
               lib.edm_attention_f32, lib.edm_int8_dense_f32, lib.edm_attention_bwd_f32):
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
