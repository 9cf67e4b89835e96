"""Self-attention over the spatial positions of an NHWC map.

Counterpart of `SpatialCrossAttention` in xdiffusion_tpu/layers/attention.py,
self-attention only: GroupNorm (K3) -> qkv Dense -> attention (K1) ->
zero-initialised proj_out Dense, added as a residual.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for
from xdiffusion_tpu_torch.ops.attention import attention_qkv


class SpatialCrossAttention(nn.Module):
    """Multi-head self-attention; heads = channels // dim_head unless
    dim_head == -1, when `heads` is used as given."""

    def __init__(self, in_channels: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 is_causal: bool = False, dtype: torch.dtype = torch.float32,
                 **unused_cross_attention_options):
        super().__init__()
        if context_dim not in (None, -1):
            raise NotImplementedError("cross-attention (context_dim) is not ported yet")
        c = in_channels
        if dim_head == -1:
            self.num_heads = heads
        else:
            if c % dim_head != 0:
                raise ValueError(f"channels {c} not divisible by dim_head {dim_head}")
            self.num_heads = c // dim_head
        self.is_causal = is_causal
        self.dropout = dropout  # sampling is deterministic: dropout is off
        self.norm = FastGroupNorm(c, num_groups_for(c))
        self.qkv = Dense(c, 3 * c, dtype=dtype)
        self.proj_out = Dense(c, c, dtype=dtype, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = self.norm(x).reshape(b, h * w, c)
        q, k, v = self.qkv(hidden).chunk(3, dim=-1)
        out = attention_qkv(q, k, v, heads=self.num_heads, is_causal=self.is_causal)
        return x + self.proj_out(out).reshape(b, h, w, c)
