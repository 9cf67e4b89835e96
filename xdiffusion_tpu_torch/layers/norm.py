"""Normalisation layers of the transformer score networks.

Counterpart of `RMSNorm` in xdiffusion_tpu/layers/norm.py.
"""

from __future__ import annotations

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
