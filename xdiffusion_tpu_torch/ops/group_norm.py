"""K3: GroupNorm (+ SiLU) over the trailing channel axis of an NHWC map.

Counterpart of xdiffusion_tpu/ops/group_norm.py. On a CUDA tensor
`group_norm_silu` launches the hand-written kernel of
`csrc/group_norm_silu.cu`; on a CPU tensor it runs the plain version
`group_norm_silu_plain`, which mirrors the JAX package's
`_xla_group_norm_silu` (two-pass fp32 statistics, eps 1e-5, the result
rounded once to the input dtype).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops._build import Kernel, dtype_code, require_cuda

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


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """silu?(group_norm(x) * scale + bias) for x (B, ..., C); scale/bias (C,)."""
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
