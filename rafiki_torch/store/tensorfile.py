"""The safetensors file format, written and read with numpy alone.

The card's machine has no ``safetensors`` package, and the reference's
``ParamStore`` writes its files with it. This module writes and reads
the same format (https://github.com/huggingface/safetensors, "Format"):
an 8-byte little-endian header length ``N``, ``N`` bytes of JSON
mapping each name to its ``dtype``, ``shape`` and ``data_offsets``
(begin, end) into the data that follows, padded with spaces to a
multiple of 8, then the raw little-endian bytes of each array.

``save_file`` lays the arrays out as the package does (by dtype, the
widest first, then by name), so for the same dict both write the same
bytes; ``load_file`` reads any well-formed file of the numpy dtypes
below.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

# safetensors' dtype names, in the order of its Rust ``Dtype`` enum
# (the file's data is sorted by this order, descending). bf16 and the
# float8 types have no numpy dtype and are not supported.
_DTYPES = [("BOOL", np.bool_), ("U8", np.uint8), ("I8", np.int8),
           ("I16", np.int16), ("U16", np.uint16), ("F16", np.float16),
           ("I32", np.int32), ("U32", np.uint32), ("F32", np.float32),
           ("F64", np.float64), ("I64", np.int64), ("U64", np.uint64)]
_RANK = {np.dtype(t): i for i, (_, t) in enumerate(_DTYPES)}
_NAME = {np.dtype(t): n for n, t in _DTYPES}
_FROM_NAME = {n: np.dtype(t).newbyteorder("<") for n, t in _DTYPES}


def save(tensors: Dict[str, np.ndarray]) -> bytes:
    """The file's bytes for a ``{name: ndarray}`` dict."""
    arrays = {}
    for name, value in tensors.items():
        a = np.asarray(value)
        dt = a.dtype.newbyteorder("=")
        if dt not in _RANK:
            raise ValueError(f"{name!r}: dtype {a.dtype} has no "
                             "safetensors name here")
        arrays[name] = a.astype(dt.newbyteorder("<"), order="C",
                                copy=False)
    order = sorted(arrays, key=lambda n: (
        -_RANK[arrays[n].dtype.newbyteorder("=")], n))
    header, blobs, offset = {}, [], 0
    for name in order:
        a = arrays[name]
        blob = a.tobytes()
        header[name] = {"dtype": _NAME[a.dtype.newbyteorder("=")],
                        "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    return struct.pack("<Q", len(text)) + text + b"".join(blobs)


def load(data: bytes) -> Dict[str, np.ndarray]:
    """``{name: ndarray}`` from a file's bytes, in the header's order;
    each array owns its memory."""
    if len(data) < 8:
        raise ValueError("not a safetensors file: shorter than 8 bytes")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError("safetensors header runs past the end")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dt = _FROM_NAME[info["dtype"]]
        shape = tuple(int(s) for s in info["shape"])
        if not 0 <= begin <= end <= len(body) or \
                end - begin != dt.itemsize * int(np.prod(shape)):
            raise ValueError(f"{name!r}: bad data_offsets {begin, end}")
        a = np.frombuffer(body[begin:end], dtype=dt).reshape(shape)
        out[name] = a.astype(dt.newbyteorder("="), copy=True)
    return out


def save_file(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write ``tensors`` to ``path`` (through a temporary file, renamed
    into place once written)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(save(tensors))
    os.replace(tmp, path)


def load_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return load(f.read())
