"""GroupNorm, the BigGAN residual block and resampling, NHWC.

Counterpart of xdiffusion_tpu/layers/resnet.py. The residual block takes
the JAX package's fused interior (layers/resnet.py:300-368): the GroupNorm
statistics reduce to per-(batch, channel) coefficients in plain PyTorch, and
K4 (ops/fused_resblock.py) applies them, the SiLU, the 3x3 convolution, the
bias and, for conv2, the skip connection in one kernel. While it drops
(training, dropout > 0, a generator in the context) conv2 leaves the fused
path as the JAX block does (layers/resnet.py:342-395): the mask sits
between norm2 and conv2.

Dropout draws its mask from `context["dropout_generator"]` (a
`torch.Generator` on the activations' device) and runs only while the
module is in training mode; without a generator the block is deterministic,
as the JAX block is by default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.ops.fused_resblock import affine_silu_conv3x3, conv2d_nhwc
from xdiffusion_tpu_torch.ops.group_norm import group_norm_silu
from xdiffusion_tpu_torch.ops.norm import (
    fold_scale_shift,
    group_norm_coefficients,
    group_norm_scale_shift,
)
from xdiffusion_tpu_torch.utils import dropout


def dropout_generator(module: nn.Module, context: Optional[Dict]):
    """The generator that `module` drops with, or None when it does not drop."""
    if not module.training or context is None:
        return None
    return context.get("dropout_generator")


def num_groups_for(c: int) -> int:
    """GroupNorm(32), with fewer groups for thin channel counts."""
    return 32 if c % 32 == 0 else max(1, c // 4)


class FastGroupNorm(nn.Module):
    """GroupNorm over the trailing channel axis (eps 1e-5), with the JAX
    package's forms:

    - plain: silu?(group_norm(x)) through K3 (ops/group_norm.py);
    - t_scale/t_shift: the adaptive scale-shift, in plain PyTorch;
    - return_coefficients: the per-(B, C) fp32 (a, off) for K4, with the
      scale-shift or an additive channel_shift folded in.
    """

    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.silu = silu
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, t_scale: Optional[torch.Tensor] = None,
                t_shift: Optional[torch.Tensor] = None,
                channel_shift: Optional[torch.Tensor] = None,
                return_coefficients: bool = False):
        if return_coefficients:
            a, off = group_norm_coefficients(x, self.scale, self.bias, self.num_groups,
                                             self.epsilon, channel_shift=channel_shift)
            if t_scale is not None:
                a, off = fold_scale_shift(x, a, off, t_scale, t_shift)
            return a, off
        if t_scale is not None:
            return group_norm_scale_shift(x, self.scale, self.bias, self.num_groups,
                                          t_scale, t_shift, eps=self.epsilon,
                                          silu=self.silu)
        if channel_shift is not None:
            raise ValueError("channel_shift needs return_coefficients=True")
        return group_norm_silu(x, self.scale, self.bias, self.num_groups,
                               self.epsilon, apply_silu=self.silu)


class FusedAffineConv(nn.Module):
    """3x3 'SAME' conv of silu(x * a + off) (+ residual) through K4.

    `kernel` keeps flax's HWIO layout (3, 3, C, Co), the layout K4 reads."""

    def __init__(self, in_channels: int, features: int, zero_init: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        kernel = torch.zeros(3, 3, in_channels, features)
        if not zero_init:
            nn.init.normal_(kernel, std=(9 * in_channels) ** -0.5)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, a, off, residual: Optional[torch.Tensor] = None):
        dt = self.compute_dtype
        return affine_silu_conv3x3(
            x.to(dt).contiguous(), a, off, self.kernel.to(dt), self.bias,
            residual=None if residual is None else residual.to(dt).contiguous(),
        )

    def plain(self, h):
        """conv3x3_same(h) + bias through `F.conv2d`, on the same HWIO kernel
        (the dropout branch's conv2, an `nn.Conv` in the JAX block)."""
        dt = self.compute_dtype
        return conv2d_nhwc(h.to(dt), self.kernel.to(dt).permute(3, 2, 0, 1),
                           self.bias.to(dt), padding=1)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C) nearest-neighbour."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C) 2x2 average."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class Downsample(nn.Module):
    """2x downsample: stride-2 3x3 conv (padding 1) if with_conv, else avg-pool."""

    def __init__(self, channels: int, with_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (ConvNHWC(channels, channels, 3, stride=2, padding=1, dtype=dtype)
                     if with_conv else None)

    def forward(self, x, context: Dict = None):
        return avg_pool_2x(x) if self.conv is None else self.conv(x)


class Upsample(nn.Module):
    """2x nearest upsample, then a 3x3 conv if with_conv."""

    def __init__(self, channels: int, with_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = (ConvNHWC(channels, channels, 3, padding=1, dtype=dtype)
                     if with_conv else None)

    def forward(self, x, context: Dict = None):
        x = nearest_upsample_2x(x)
        return x if self.conv is None else self.conv(x)


class ResnetBlockBigGAN(nn.Module):
    """BigGAN residual block with scale-shift (or additive) timestep
    conditioning, through the fused interior:

        h = K4(x; norm1 coefficients)                     # conv1
        out = K4(h; norm2 coefficients with emb folded) + skip(x)   # conv2

    or, while dropping: out = skip(x) + conv2(dropout(norm2(h, emb)))."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int,
                 use_scale_shift_norm: bool = True, use_conv: bool = False,
                 up: bool = False, down: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if up or down:
            raise NotImplementedError(
                "resampling residual blocks (resblock_updown) are not ported yet"
            )
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.norm1 = FastGroupNorm(dim_in, num_groups_for(dim_in))
        self.conv1 = FusedAffineConv(dim_in, dim_out, dtype=dtype)
        self.emb_proj = Dense(emb_dim, 2 * dim_out if use_scale_shift_norm else dim_out,
                              dtype=dtype)
        self.norm2 = FastGroupNorm(dim_out, num_groups_for(dim_out), silu=True)
        self.conv2 = FusedAffineConv(dim_out, dim_out, zero_init=True, dtype=dtype)
        if dim_in != dim_out:
            k = 3 if use_conv else 1
            self.skip = ConvNHWC(dim_in, dim_out, k, padding=k // 2, dtype=dtype)
        else:
            self.skip = None

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        a1, o1 = self.norm1(x, return_coefficients=True)
        h = self.conv1(x, a1, o1)
        emb = context["timestep_embedding"]
        if "class_embedding" in context:
            emb = emb + context["class_embedding"]
        emb_out = self.emb_proj(F.silu(emb))[:, None, None, :]
        generator = dropout_generator(self, context)
        if generator is not None and self.dropout > 0.0:
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=-1)
                h = self.norm2(h, t_scale=scale, t_shift=shift)
            else:
                h = self.norm2(h + emb_out)
            h = self.conv2.plain(dropout(h, self.dropout, generator))
            if self.skip is not None:
                x = self.skip(x)
            return x + h
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            a2, o2 = self.norm2(h, t_scale=scale, t_shift=shift, return_coefficients=True)
        else:
            a2, o2 = self.norm2(h, channel_shift=emb_out, return_coefficients=True)
        if self.skip is not None:
            x = self.skip(x)
        return self.conv2(h, a2, o2, residual=x)
