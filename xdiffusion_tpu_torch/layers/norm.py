"""Normalisation layers of the transformer score networks and the text
heads.

Counterpart of `RMSNorm` and `DynamicTanhNorm` in
xdiffusion_tpu/layers/norm.py, and of flax's `nn.LayerNorm` as the JAX
package's text layers use it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned scale: the statistics in fp32,
    the normalised value rounded to the input's dtype, then scaled (which
    promotes as the scale's dtype asks, as in flax)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        rrms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * rrms).to(x.dtype) * self.scale


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis: mean and E[x^2] - mean^2 in
    fp32 (fp64 for an fp64 input), (x - mean) * rsqrt(var + eps) * scale
    (+ bias), the result in `dtype`, or, with none, in the promotion of x's
    dtype and fp32 (the parameters' dtype), as flax infers it."""

    def __init__(self, dim: int, eps: float = 1e-6, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.compute_dtype or torch.promote_types(x.dtype, torch.float32))


class DynamicTanhNorm(nn.Module):
    """DyT, the norm-free LayerNorm replacement ("Transformers without
    Normalization"): tanh(alpha * x) * gamma + beta, with a scalar `alpha`
    (initially 0.5) and per-channel `gamma` and `beta`."""

    def __init__(self, dim: int, alpha_init: float = 0.5):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(float(alpha_init)))
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.alpha * x) * self.gamma + self.beta
