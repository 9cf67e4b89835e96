"""Builds the hand-written Hopper kernels and binds them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries land in `xdiffusion_tpu_torch/_build/`, named by a hash
of their source, every header of `csrc/` and the flags, so an edited source
builds anew and an unchanged one is reused. `build` starts one `nvcc` per
source at once;
a kernel's first launch builds just its own library if it is missing.

A kernel's entry point returns 0 or an error code (a `cudaError_t`, or one
of the XD_ERR_* codes of `csrc/common.cuh`); `Kernel.launch` raises on
anything else and counts each launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {1001: "unsupported dtype", 1002: "unsupported shape"}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels build only where the CUDA toolkit is")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str, verbose: bool) -> Optional[subprocess.Popen]:
    """Starts nvcc for `name` unless its library exists; returns the process."""
    lib = _library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.xd_name, proc.xd_tmp, proc.xd_lib = name, tmp, lib
    return proc


def _finish_build(proc: subprocess.Popen, verbose: bool) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(proc.xd_tmp)
        raise RuntimeError(f"nvcc failed for {proc.xd_name}.cu:\n{log}")
    if verbose and log.strip():
        print(f"[nvcc {proc.xd_name}]\n{log.strip()}", flush=True)
    os.replace(proc.xd_tmp, proc.xd_lib)  # atomic: readers see whole files
    return log


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, str]:
    """Builds the named kernel libraries, one nvcc each, all in parallel;
    returns each built library's compiler output (with `verbose`, ptxas's
    registers, shared memory and spills per kernel)."""
    procs = [p for p in (_start_build(n, verbose) for n in names) if p is not None]
    errors: List[str] = []
    logs: Dict[str, str] = {}
    for p in procs:
        try:
            logs[p.xd_name] = _finish_build(p, verbose)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


class Kernel:
    """One kernel library: lazy build and load, checked launches, a count.

    `launches` counts the launches of the kernel; callers may reset it."""

    def __init__(self, name: str, fn: str, argtypes: Sequence):
        self.name = name
        self._fn_name = fn
        self._argtypes = list(argtypes)
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()
        self.launches = 0

    def _load(self):
        with self._lock:
            if self._fn is None:
                build([self.name])
                lib = ctypes.CDLL(_library_path(self.name))
                fn = getattr(lib, self._fn_name)
                self._lib = lib
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def symbol(self, fn: str, argtypes: Sequence):
        """Another entry point of the kernel's library (returning an int),
        for queries beside the launch; its calls are not counted."""
        if self._lib is None:
            self._load()
        f = getattr(self._lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f

    def launch(self, *args) -> None:
        """Calls the C entry point on the current stream; raises on failure."""
        fn = self._fn or self._load()
        rc = fn(*args, _current_stream())
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: launch failed with code {rc} "
                f"({_ERRORS.get(rc, 'cudaError_t')})"
            )
        self.launches += 1


def _current_stream() -> int:
    """The current CUDA stream's handle. The raw query skips building a
    `torch.cuda.Stream` object: wrappers on host-bound paths pay for every
    microsecond."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of `tensors`, which must be CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CPU or CUDA tensors, got {dev}")
    return dev


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    return DTYPE_CODES[t.dtype]


def plain_vjp(plain, inputs, g, needs):
    """Gradients of plain(*inputs) for the cotangent g, by recomputing it
    under autograd; None where `needs` is False."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


def kernels() -> Dict[str, Kernel]:
    """Every kernel of the port, by name (imports the op modules)."""
    from xdiffusion_tpu_torch.ops import flash_attention, fused_resblock, group_norm

    return {
        k.name: k
        for k in (flash_attention.KERNEL, flash_attention.BWD_KERNEL,
                  flash_attention.FLASH_KERNEL, flash_attention.FLASH_BWD_KERNEL,
                  flash_attention.SHORT_KERNEL, group_norm.KERNEL, fused_resblock.KERNEL)
    }
