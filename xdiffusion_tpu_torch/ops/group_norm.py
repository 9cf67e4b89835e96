"""K3: GroupNorm (+ SiLU) over the trailing channel axis of an NHWC map.

Counterpart of xdiffusion_tpu/ops/group_norm.py. `group_norm_silu` is a
`torch.autograd.Function`. On a CUDA tensor its forward launches the
hand-written kernel of `csrc/group_norm_silu.cu`; on a CPU tensor it runs
the plain version `group_norm_silu_plain`, which mirrors the JAX package's
`_xla_group_norm_silu` (two-pass fp32 statistics, eps 1e-5, the result
rounded once to the input dtype). The JAX package has no backward kernel
for it (XLA differentiates the composition), so the backward recomputes the
plain version under autograd and backpropagates through it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, plain_vjp, require_cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = Kernel(
    "group_norm_silu", "xd_group_norm_silu",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
)


def group_norm_silu_plain(x, scale, bias, num_groups: int, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    c = x.shape[-1]
    grouped = x.float().reshape(*x.shape[:-1], num_groups, c // num_groups)
    axes = tuple(range(1, grouped.ndim - 2)) + (grouped.ndim - 1,)
    mean = grouped.mean(dim=axes, keepdim=True)
    var = grouped.var(dim=axes, correction=0, keepdim=True)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = normed * scale.float() + bias.float()
    if apply_silu:
        out = F.silu(out)
    return out.to(x.dtype)


def _forward(x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
    require_cuda("group_norm_silu", x, scale, bias)
    code = dtype_code("group_norm_silu", x)
    c = x.shape[-1]
    if x.ndim < 2 or c % num_groups != 0:
        raise ValueError(f"group_norm_silu: {num_groups} groups do not divide {c} channels")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("group_norm_silu: scale and bias must be (C,)")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be contiguous")
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    hw = x[0].numel() // c
    KERNEL.launch(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  x.shape[0], hw, c, num_groups, eps, int(apply_silu), code)
    return out


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, apply_silu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        return _forward(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, apply_silu = ctx.args
        grads = plain_vjp(
            lambda x, s, b: group_norm_silu_plain(x, s, b, num_groups, eps, apply_silu),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return grads + (None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """silu?(group_norm(x) * scale + bias) for x (B, ..., C); scale/bias (C,).
    Differentiable in x, scale and bias."""
    return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
