"""Dense and convolution layers with the JAX package's compute-dtype policy:
parameters stay fp32 and each call computes in the layer's `dtype`
(flax's `dtype=` argument); a layer with no dtype promotes its input to
the parameters' fp32, as flax does."""

from __future__ import annotations

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
