"""Reading and writing `.safetensors` files without the `safetensors` package.

The format: an 8-byte little-endian header length, a JSON header that maps
each tensor's name to its dtype, shape and `data_offsets` (begin and end in
bytes, counted from the end of the header) beside an optional
`__metadata__` entry of strings, then the raw little-endian buffers.
F32, F16 and BF16 tensors are read into torch tensors and written from them.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a `.safetensors` file of F32, F16 and BF16
    tensors (in the file's order)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"F32, F16 and BF16 are read")
        begin, end = info["data_offsets"]
        shape = tuple(int(s) for s in info["shape"])
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype) if end > begin \
            else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape)
    return out


def save_safetensors(path: str, tensors: Mapping[str, object]) -> None:
    """Writes {name: tensor or float32 numpy array} as a `.safetensors` file
    (F32, F16 or BF16), the tensors in name order, 8-byte aligned."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(t, dtype=np.float32)))
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; F32, F16 and BF16 are written")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
