"""The safetensors file format in numpy (the ``safetensors`` package is not
installed on the card's machine).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and
end, relative to the end of the header; an optional ``__metadata__`` entry
holds strings), then the tensors' raw little-endian bytes. The dtypes are
those the model directories use: F32, F16, BF16, I64, I32, I8 and BOOL.
``load_file`` gives numpy arrays, BF16 as ``torch.bfloat16`` tensors (numpy
has no bfloat16); ``save_file`` writes numpy arrays or torch tensors, in
name order.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np
import torch

# safetensors' dtype names and their little-endian numpy dtypes
DTYPES = {
    "F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"), "I8": np.dtype("i1"), "BOOL": np.dtype("?"),
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def load_file(path: str) -> dict[str, np.ndarray | torch.Tensor]:
    """Every tensor of the file at ``path``: numpy arrays, BF16 as bf16
    tensors."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]
    out: dict[str, np.ndarray | torch.Tensor] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        if entry["dtype"] == "BF16":
            bits = np.frombuffer(body[begin:end], np.dtype("<i2")).reshape(shape)
            out[name] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        elif entry["dtype"] in DTYPES:
            out[name] = np.frombuffer(body[begin:end], DTYPES[entry["dtype"]]).reshape(shape).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, "
                             f"which this reader does not take")
    return out


def _encode(name: str, t: np.ndarray | torch.Tensor) -> tuple[str, list[int], bytes]:
    """(safetensors dtype, shape, little-endian bytes) of one tensor."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", list(t.shape), t.view(torch.int16).numpy().astype("<i2").tobytes()
        t = t.numpy()
    arr = np.asarray(t)
    dt = arr.dtype.newbyteorder("<")
    if dt not in _NAMES:
        raise ValueError(f"tensor {name!r}: dtype {arr.dtype} is not a safetensors dtype")
    return _NAMES[dt], list(arr.shape), arr.astype(dt).tobytes()


def save_file(tensors: Mapping[str, np.ndarray | torch.Tensor], path: str,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors) to ``path``."""
    header: dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks, offset = [], 0
    for name in sorted(tensors):
        dtype, shape, data = _encode(name, tensors[name])
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts on 8 bytes, as safetensors writes it
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in chunks:
            f.write(data)
