"""Self-attention layers: over the spatial positions of an NHWC map, and
over a token sequence.

Counterpart of `SpatialCrossAttention` (self-attention only) and
`MultiHeadSelfAttention` in xdiffusion_tpu/layers/attention.py.
`SpatialCrossAttention`: GroupNorm (K3) -> qkv Dense -> attention (K1, and K2
in its backward) -> zero-initialised proj_out Dense -> dropout, added as a
residual. `MultiHeadSelfAttention` (the DiT's): qkv Dense with a bias, its
three column slices straight into K1 (no copy), proj Dense, dropout. Dropout
runs as in the residual block (layers/resnet.py): in training mode, with
`context["dropout_generator"]`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.resnet import (
    FastGroupNorm,
    dropout_generator,
    num_groups_for,
)
from xdiffusion_tpu_torch.ops.attention import attention_qkv
from xdiffusion_tpu_torch.utils import dropout


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
        self.dropout = dropout
        self.norm = FastGroupNorm(c, num_groups_for(c))
        self.qkv = Dense(c, 3 * c, dtype=dtype)
        self.proj_out = Dense(c, c, dtype=dtype, zero_init=True)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = self.norm(x).reshape(b, h * w, c)
        q, k, v = self.qkv(hidden).chunk(3, dim=-1)
        out = attention_qkv(q, k, v, heads=self.num_heads, is_causal=self.is_causal)
        out = self.proj_out(out)
        generator = dropout_generator(self, context)
        if generator is not None:
            out = dropout(out, self.dropout, generator)
        return x + out.reshape(b, h, w, c)


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention over (B, N, C) tokens, C = num_heads *
    head_dim."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = self.proj(attention_qkv(q, k, v, heads=self.num_heads))
        generator = dropout_generator(self, context)
        if generator is not None:
            out = dropout(out, self.dropout, generator)
        return out
