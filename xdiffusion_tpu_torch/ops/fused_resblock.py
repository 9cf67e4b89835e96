"""K4: fused affine + SiLU + 3x3 conv (+ residual) for the residual blocks.

Counterpart of xdiffusion_tpu/ops/fused_resblock.py:

    out = conv3x3_same(silu(x * a + off), w) + bias [+ residual]

with x (B, H, W, C) NHWC, a/off (B, C) per-(batch, channel) fp32
coefficients (a GroupNorm with any timestep scale-shift folded in, see
ops/norm.py), w (3, 3, C, Co) HWIO, bias (Co,), residual (B, H, W, Co).

The weight stays in the JAX package's HWIO layout: the kernel of
`csrc/affine_silu_conv3x3.cu` reads it as the (9*C, Co) row-major matrix
of its implicit GEMM. On CPU tensors the plain version runs; it mirrors
the JAX package's `_xla_impl` (affine and SiLU in the activation dtype,
then the convolution).

`affine_silu_conv3x3` is a `torch.autograd.Function` whose forward is the
kernel. Its backward is, as in the JAX package's custom vjp
(fused_resblock.py:223-242), autograd of the plain version without the
residual, and the cotangent itself for the residual.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, plain_vjp, require_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel(
    "affine_silu_conv3x3", "xd_affine_silu_conv3x3",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor, bias=None, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """F.conv2d on NHWC tensors (OIHW weight); returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def affine_silu_conv3x3_plain(x, a, off, kernel_w, bias, residual=None,
                              apply_silu: bool = True) -> torch.Tensor:
    bsz, c = x.shape[0], x.shape[-1]
    y = x * a.reshape(bsz, 1, 1, c).to(x.dtype) + off.reshape(bsz, 1, 1, c).to(x.dtype)
    if apply_silu:
        y = F.silu(y)
    out = conv2d_nhwc(y, kernel_w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    out = out + bias.to(x.dtype)
    if residual is not None:
        out = out + residual
    return out


def _forward(x, a, off, kernel_w, bias, residual, apply_silu: bool) -> torch.Tensor:
    bsz, h, w, c = x.shape
    co = kernel_w.shape[-1]
    if x.device.type == "cpu":
        return affine_silu_conv3x3_plain(x, a, off, kernel_w, bias, residual, apply_silu)
    tensors = (x, a, off, kernel_w, bias) + (() if residual is None else (residual,))
    require_cuda("affine_silu_conv3x3", *tensors)
    code = dtype_code("affine_silu_conv3x3", x)
    if kernel_w.dtype != x.dtype or (residual is not None and residual.dtype != x.dtype):
        raise TypeError("affine_silu_conv3x3: x, kernel_w and residual must share a dtype")
    if kernel_w.shape[2] != c or bias.shape != (co,):
        raise ValueError(f"affine_silu_conv3x3: kernel {tuple(kernel_w.shape)} for {c} channels")
    if residual is not None and residual.shape != (bsz, h, w, co):
        raise ValueError(f"affine_silu_conv3x3: residual {tuple(residual.shape)}")
    if not (x.is_contiguous() and kernel_w.is_contiguous()
            and (residual is None or residual.is_contiguous())):
        raise ValueError("affine_silu_conv3x3: x, kernel_w and residual must be contiguous")
    a = a.float().contiguous()
    off = off.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty((bsz, h, w, co), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), a.data_ptr(), off.data_ptr(), kernel_w.data_ptr(),
                  bias.data_ptr(), None if residual is None else residual.data_ptr(),
                  out.data_ptr(), bsz, h, w, c, co, int(apply_silu), code)
    return out


class _AffineSiLUConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, off, kernel_w, bias, residual, apply_silu: bool):
        ctx.save_for_backward(x, a, off, kernel_w, bias)
        ctx.apply_silu = apply_silu
        return _forward(x, a, off, kernel_w, bias, residual, apply_silu)

    @staticmethod
    def backward(ctx, g):
        apply_silu = ctx.apply_silu
        grads = plain_vjp(
            lambda *ops: affine_silu_conv3x3_plain(*ops, None, apply_silu),
            ctx.saved_tensors, g, ctx.needs_input_grad[:5])
        return grads + (g if ctx.needs_input_grad[5] else None, None)


def affine_silu_conv3x3(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor,
                        kernel_w: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        apply_silu: bool = True) -> torch.Tensor:
    """conv3x3_same(silu(x * a + off), kernel_w) + bias [+ residual],
    differentiable in every tensor argument."""
    if kernel_w.ndim != 4 or kernel_w.shape[:2] != (3, 3):
        raise ValueError("affine_silu_conv3x3: 3x3 HWIO kernels only")
    bsz, c = x.shape[0], x.shape[-1]
    return _AffineSiLUConv3x3.apply(x, a.reshape(bsz, c), off.reshape(bsz, c), kernel_w,
                                    bias, residual, apply_silu)
