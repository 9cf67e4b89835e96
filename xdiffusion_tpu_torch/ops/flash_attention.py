"""K1 and K2: fused non-causal attention in the (B, S, C=H*D) qkv-projection
layout, forward and backward.

Counterpart of `short_attention_bsc` in xdiffusion_tpu/ops/flash_attention.py
and its custom vjp. `short_attention_bsc` is a `torch.autograd.Function`:
its forward launches K1 (`csrc/bsc_attention.cu`) on CUDA tensors and saves
q, k and v; its backward launches K2 (`csrc/bsc_attention_bwd.cu`). On CPU
tensors the two plain versions run instead:

- the forward is the head-batched einsum path (`ops.attention.attention_bshd`):
  fp32 logits, fp32 softmax, probabilities rounded to v's dtype before PV;
- the backward, `short_attention_bsc_bwd_plain`, transcribes the TPU backward
  kernel `_bsc_bwd_kernel` with its three roundings (p to v's dtype, p back to
  fp32 for the row sum, ds * scale to q's dtype).
"""

from __future__ import annotations

import ctypes

import torch

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
KERNEL = Kernel(
    "bsc_attention", "xd_bsc_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
BWD_KERNEL = Kernel(
    "bsc_attention_bwd", "xd_bsc_attention_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _F, _I, _P],
)
HEAD_DIMS = (16, 32, 64, 128)


def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = t.shape
    return t.reshape(b, s, heads, c // heads)


def short_attention_bsc_plain(q, k, v, heads: int, scale: float) -> torch.Tensor:
    from xdiffusion_tpu_torch.ops.attention import attention_bshd

    out = attention_bshd(_heads_view(q, heads), _heads_view(k, heads),
                         _heads_view(v, heads), scale=scale)
    return out.reshape(q.shape)


def short_attention_bsc_bwd_plain(q, k, v, g, heads: int, scale: float):
    """(dq, dk, dv) of `short_attention_bsc` for the output cotangent g
    (B, Sq, C), as the TPU kernel computes them (flash_attention.py:366-399):

        p  = softmax(q k^T * scale) rounded to v's dtype
        dv = p^T g;   dp = g v^T (fp32)
        ds = p (dp - rowsum(dp * p)) * scale, rounded to q's dtype
        dq = ds k;    dk = ds^T q

    Every product accumulates in fp32 and rounds once to its output's dtype."""
    qh, kh, vh, gh = (_heads_view(t, heads).float() for t in (q, k, v, g))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    pf = p.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pf, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def _check(name: str, heads: int, q: torch.Tensor, *others: torch.Tensor) -> int:
    """Validates CUDA operands the kernels read in place; returns the dtype
    code. Each needs a unit stride on C and rows on 16-byte boundaries."""
    require_cuda(name, q, *others)
    code = dtype_code(name, q)
    if any(t.dtype != q.dtype for t in others):
        raise TypeError(f"{name}: q, k, v (and g) must share a dtype")
    b, _, c = q.shape
    if c % heads != 0 or c // heads not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {c}/{heads} not in {HEAD_DIMS}")
    item = q.element_size()
    for t in (q,) + others:
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != c:
            raise ValueError(f"{name}: shape {tuple(t.shape)} against q {tuple(q.shape)}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: operands need unit stride on C")
        if t.data_ptr() % 16 or (t.stride(0) * item) % 16 or (t.stride(1) * item) % 16:
            raise ValueError(f"{name}: operand rows must be 16-byte aligned")
    return code


def _strides(*tensors: torch.Tensor):
    vals = [s for t in tensors for s in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _forward(q, k, v, heads: int, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return short_attention_bsc_plain(q, k, v, heads, scale)
    code = _check("short_attention_bsc", heads, q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"short_attention_bsc: k {tuple(k.shape)} and v {tuple(v.shape)}")
    b, sq, c = q.shape
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, k.shape[1], heads, c // heads, _strides(q, k, v, out),
                  float(scale), code)
    return out


def short_attention_bsc_bwd(q, k, v, g, heads: int, scale: float):
    """(dq, dk, dv): K2 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return short_attention_bsc_bwd_plain(q, k, v, g, heads, scale)
    code = _check("short_attention_bsc_bwd", heads, q, k, v, g)
    if k.shape != v.shape or g.shape != q.shape:
        raise ValueError("short_attention_bsc_bwd: k/v or g shape mismatch")
    b, sq, c = q.shape
    sk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Per-row softmax statistics (max, sum, rowsum(dp * p)) that the dq pass
    # hands to the dk/dv pass.
    stats = torch.empty((3, b, heads, sq), dtype=torch.float32, device=q.device)
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                      b, sq, sk, heads, c // heads, _strides(q, k, v, g, dq, dk, dv),
                      float(scale), code)
    return dq, dk, dv


class _ShortAttentionBSC(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return _forward(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = short_attention_bsc_bwd(q, k, v, g.contiguous(), ctx.heads,
                                             ctx.scale)
        return dq, dk, dv, None, None


def short_attention_bsc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """q: (B, Sq, C); k/v: (B, Sk, C), C = heads * head_dim. Returns (B, Sq, C),
    differentiable in q, k and v.

    q, k and v may be column slices of one qkv projection: each needs a unit
    stride on its last axis and rows that start on 16-byte boundaries."""
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"short_attention_bsc: shapes {tuple(q.shape)}, {tuple(k.shape)}")
    return _ShortAttentionBSC.apply(q, k, v, heads, scale)
