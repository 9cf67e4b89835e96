"""Dense and convolution layers with the JAX package's compute-dtype policy:
parameters stay fp32 and each call computes in the layer's `dtype`
(flax's `dtype=` argument); a layer with no dtype promotes its input to
the parameters' fp32, as flax does."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.ops.fused_resblock import conv2d_nhwc


class Dense(nn.Linear):
    """flax `nn.Dense`: weight (out, in) (the transpose of flax's kernel);
    `bias=False` is flax's `use_bias=False`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = torch.float32, zero_init: bool = False,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        if zero_init:
            nn.init.zeros_(self.weight)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class ConvNHWC(nn.Conv2d):
    """flax `nn.Conv` on NHWC maps: weight OIHW, symmetric padding; `groups`
    is flax's `feature_group_count` (a depthwise conv's weight is (C, 1, H,
    W), flax's HWIO (H, W, 1, C) transposed)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: Optional[torch.dtype] = torch.float32, groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, groups=groups)
        self.compute_dtype = dtype
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d_nhwc(x.to(dt), self.weight.to(dt), b, self.stride, self.padding,
                           self.groups)


def same_padding(size: int, kernel: int, stride: int):
    """XLA's "SAME" padding of one axis: (low, high), the odd one high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv` on channel-last maps with 2 or 3 spatial axes (NHWC or
    NDHWC): weight (O, I, *kernel), flax's kernel (*kernel, I, O) moved;
    `padding` "SAME" (XLA's: the odd pad on the high side), "VALID" or one
    (low, high) pair per spatial axis, zero fill; computed in fp32 (the VAEs
    and the perceptual loss, whose convs flax runs with no dtype on fp32
    maps). Runs as F.conv2d / F.conv3d on the channels-first view."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=1,
                 padding="SAME", bias: bool = True):
        super().__init__()
        nd = len(kernel)
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = (int(stride),) * nd if isinstance(stride, int) else tuple(stride)
        self.padding = padding
        fan_in = in_channels * math.prod(self.kernel)
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels, *self.kernel) * fan_in ** -0.5)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def pads(self, spatial) -> list:
        if self.padding == "SAME":
            return [same_padding(n, k, s) for n, k, s in zip(spatial, self.kernel, self.stride)]
        if self.padding == "VALID":
            return [(0, 0)] * len(self.kernel)
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = self.pads(x.shape[1:-1])
        xc = x.movedim(-1, 1)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        return conv(xc, self.weight, self.bias, self.stride, padding).movedim(1, -1)
