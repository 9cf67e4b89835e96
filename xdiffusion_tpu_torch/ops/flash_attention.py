"""K1: fused non-causal attention in the (B, S, C=H*D) qkv-projection layout.

Counterpart of `short_attention_bsc` in xdiffusion_tpu/ops/flash_attention.py
(forward only). On CUDA tensors it launches the hand-written kernel of
`csrc/bsc_attention.cu`; on CPU tensors it runs the plain version, which
is the head-batched einsum path (`ops.attention.attention_bshd`): fp32
logits, fp32 softmax, probabilities rounded to v's dtype before PV.
"""

from __future__ import annotations

import ctypes

import torch

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "bsc_attention", "xd_bsc_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong), _F, _I,
     _P],
)
HEAD_DIMS = (16, 32, 64, 128)


def short_attention_bsc_plain(q, k, v, heads: int, scale: float) -> torch.Tensor:
    from xdiffusion_tpu_torch.ops.attention import attention_bshd

    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    out = attention_bshd(
        q.reshape(b, sq, heads, d), k.reshape(b, sk, heads, d),
        v.reshape(b, sk, heads, d), scale=scale,
    )
    return out.reshape(b, sq, c)


def short_attention_bsc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """q: (B, Sq, C); k/v: (B, Sk, C), C = heads * head_dim. Returns (B, Sq, C).

    q, k and v may be column slices of one qkv projection: each needs a unit
    stride on its last axis and rows that start on 16-byte boundaries."""
    if q.device.type == "cpu":
        return short_attention_bsc_plain(q, k, v, heads, scale)
    require_cuda("short_attention_bsc", q, k, v)
    code = dtype_code("short_attention_bsc", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("short_attention_bsc: q, k and v must share a dtype")
    b, sq, c = q.shape
    if k.ndim != 3 or k.shape != v.shape or k.shape[0] != b or k.shape[2] != c:
        raise ValueError(f"short_attention_bsc: shapes {q.shape}, {k.shape}, {v.shape}")
    if c % heads != 0 or c // heads not in HEAD_DIMS:
        raise ValueError(f"short_attention_bsc: head dim {c}/{heads} not in {HEAD_DIMS}")
    item = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"short_attention_bsc: {name} needs unit stride on C")
        if t.data_ptr() % 16 or (t.stride(0) * item) % 16 or (t.stride(1) * item) % 16:
            raise ValueError(f"short_attention_bsc: {name} rows must be 16-byte aligned")
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
    )
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, k.shape[1], heads, c // heads, strides, float(scale), code)
    return out
