"""A numpy reader of the safetensors format — the only safetensors code
of the port (the GPU machine has no `safetensors` package).

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the byte buffer after the header; ``__metadata__`` is
skipped), then the raw little-endian buffers.  `safe_open` maps the file
with `np.memmap` and returns copies, like ``safetensors.safe_open(path,
framework="np")``.  Dtypes: F32, F16, BF16, I32, I64, I8, U8 (MXFP4
blocks and scales); others raise.  BF16 has no numpy type: it is read as
uint16 and widened to float32 exactly (the 16 bits become the float's
high half).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List

import numpy as np

_DTYPES = {
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),  # MXFP4 expert blocks and scales
}


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns → the float32 values they encode."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


class SafeOpen:
    """`keys()` / `get_tensor(name)` over one mapped safetensors file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.path = path
        header.pop("__metadata__", None)
        self._header: Dict[str, dict] = header
        self._base = 8 + n
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def keys(self) -> List[str]:
        return sorted(self._header)

    def get_tensor(self, name: str) -> np.ndarray:
        info = self._header[name]
        dt = _DTYPES.get(info["dtype"])
        if dt is None:
            raise NotImplementedError(f"safetensors dtype {info['dtype']} not ported")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != int(np.prod(shape, dtype=np.int64)) * dt.itemsize:
            raise ValueError(f"{name}: {end - begin} bytes do not hold "
                             f"{info['dtype']}{list(shape)}")
        buf = self._mm[self._base + begin:self._base + end]
        arr = np.frombuffer(buf, dtype=dt).reshape(shape)
        if info["dtype"] == "BF16":
            return bf16_to_f32(arr)
        return arr.astype(dt.newbyteorder("="), copy=True)

    def __enter__(self) -> "SafeOpen":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._mm = None


def safe_open(path: str) -> SafeOpen:
    return SafeOpen(path)


def load_file(path: str) -> Dict[str, np.ndarray]:
    with safe_open(path) as f:
        return {k: f.get_tensor(k) for k in f.keys()}
