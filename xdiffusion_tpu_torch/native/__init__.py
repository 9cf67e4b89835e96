"""The native (C++) host batch assembler, bound through ctypes.

Counterpart of xdiffusion_tpu/native: the per-step gather of the sampled
examples out of the uint8 dataset arena and their normalisation to float32
(`gather_normalize`), and the label gather (`gather_i32`), run in
`batchgen.cpp`, built with g++ into `native/build/libbatchgen-<source
hash>.so` at first use. `XDIFFUSION_NO_NATIVE=1` takes numpy instead (the
same values bit for bit: uint8 -> float32 times the float32 scale). Unlike
the JAX package, a failed build raises instead of falling back to numpy,
and a gather starts a thread for each MiB of its output, not one a core.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "batchgen.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> str:
    # Keyed on the source's hash: a checkout keeps no mtimes.
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "build", f"libbatchgen-{digest}.so")


def disabled() -> bool:
    return os.environ.get("XDIFFUSION_NO_NATIVE", "0") == "1"


def load() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None when `XDIFFUSION_NO_NATIVE=1`.
    Raises RuntimeError if g++ fails."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"  # concurrent processes each rename their own
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC, "-lpthread"]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or e
                raise RuntimeError(f"native batch assembler: {' '.join(cmd)} failed: {detail} "
                                   "(XDIFFUSION_NO_NATIVE=1 assembles batches in numpy)") from e
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.gather_normalize_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int]
        lib.gather_i32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p]
        lib.gather_normalize_u8.restype = lib.gather_i32.restype = None
        _lib = lib
        return lib


def _indices(idx: np.ndarray, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        # numpy's failure, not an out-of-bounds read.
        raise IndexError(f"gather index out of range [0, {n})")
    return idx


def gather_normalize(arena: np.ndarray, idx: np.ndarray,
                     scale: float = 1.0 / 255.0) -> np.ndarray:
    """float32 arena[idx] * float32(scale). arena: uint8 (N, ...); idx (B,).
    An arena that is not C-contiguous uint8 takes numpy, as in JAX."""
    idx = _indices(idx, arena.shape[0])
    lib = load()
    if lib is None or arena.dtype != np.uint8 or not arena.flags.c_contiguous:
        return arena[idx].astype(np.float32) * np.float32(scale)
    out = np.empty((idx.shape[0],) + arena.shape[1:], dtype=np.float32)
    # A thread for each MiB of output at most: the JAX package starts one a
    # core, and at a 32x32 batch of 128 (0.5 MiB) starting them took some
    # 40x the gather (2.8 ms against numpy's 0.06 on an H100 machine's host).
    threads = max(1, min(os.cpu_count() or 1, out.nbytes >> 20))
    lib.gather_normalize_u8(arena.ctypes.data, idx.ctypes.data, int(idx.shape[0]),
                            int(np.prod(arena.shape[1:])), ctypes.c_float(scale),
                            out.ctypes.data, threads)
    return out


def gather_i32(labels: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """int32 labels[idx]; labels (N,) int32 (another dtype or rank, such as
    a video's (N, digits) labels, takes numpy)."""
    idx = _indices(idx, labels.shape[0])
    lib = load()
    if (lib is None or labels.dtype != np.int32 or labels.ndim != 1
            or not labels.flags.c_contiguous):
        return labels[idx].astype(np.int32)
    out = np.empty(idx.shape, dtype=np.int32)
    lib.gather_i32(labels.ctypes.data, idx.ctypes.data, int(idx.shape[0]), out.ctypes.data)
    return out
