"""GroupNorm as per-(batch, channel) affine coefficients, in plain PyTorch.

Counterpart of xdiffusion_tpu/ops/norm.py: one-pass fp32 statistics
(E[x^2] - E[x]^2, clamped at 0, eps 1e-5), reduced per channel over the
spatial axes and then per group, so that group_norm(x) == x * a + off.
The residual blocks hand (a, off) to K4 (ops/fused_resblock.py), which
applies them while it loads the convolution's input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm_coefficients(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, eps: float = 1e-5,
                            channel_shift: Optional[torch.Tensor] = None):
    """(a, off), each (B, C) fp32, with group_norm(x) == x * a + off.

    channel_shift (B, C): the coefficients of group_norm(x + shift) as an
    affine of the unshifted x (additive timestep conditioning)."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    spatial = tuple(range(1, x.ndim - 1))
    n_sp = 1
    for ax in spatial:
        n_sp *= x.shape[ax]
    n = cg * n_sp
    xf = x.float()
    s1 = xf.sum(dim=spatial)
    s2 = xf.square().sum(dim=spatial)
    if channel_shift is not None:
        p = channel_shift.reshape(b, c).float()
        s2 = s2 + 2.0 * p * s1 + n_sp * p.square()
        s1 = s1 + n_sp * p
    g1 = s1.reshape(b, num_groups, cg).sum(-1)
    g2 = s2.reshape(b, num_groups, cg).sum(-1)
    mean = g1 / n
    var = g2 / n - mean.square()
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    inv_c = inv.repeat_interleave(cg, dim=1)
    mean_c = mean.repeat_interleave(cg, dim=1)
    a = inv_c * scale.float()[None, :]
    off = bias.float()[None, :] - mean_c * a
    if channel_shift is not None:
        off = off + p * a
    return a, off


def _apply_affine(x, a, off, silu: bool):
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x * a.reshape(shape).to(x.dtype) + off.reshape(shape).to(x.dtype)
    return F.silu(y) if silu else y


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5, silu: bool = False):
    """silu?(group_norm(x) * scale + bias) in one elementwise pass."""
    a, off = group_norm_coefficients(x, scale, bias, num_groups, eps)
    return _apply_affine(x, a, off, silu)


def fold_scale_shift(x, a, off, t_scale, t_shift):
    """Folds the adaptive scale-shift into the coefficients:
    a * (1 + ts), off * (1 + ts) + tsh."""
    ts = t_scale.reshape(x.shape[0], -1).float()
    tsh = t_shift.reshape(x.shape[0], -1).float()
    return a * (1.0 + ts), off * (1.0 + ts) + tsh


def group_norm_scale_shift(x, scale, bias, num_groups: int, t_scale, t_shift,
                           eps: float = 1e-5, silu: bool = True):
    """silu?(group_norm(x) * (1 + t_scale) + t_shift); t_scale/t_shift (B, C)."""
    a, off = group_norm_coefficients(x, scale, bias, num_groups, eps)
    a2, off2 = fold_scale_shift(x, a, off, t_scale, t_shift)
    return _apply_affine(x, a2, off2, silu)
