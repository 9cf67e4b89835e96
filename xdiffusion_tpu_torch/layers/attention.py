"""Attention layers: over the spatial positions of an NHWC map (self or
cross), and over a token sequence.

Counterpart of `SpatialCrossAttention` and `MultiHeadSelfAttention` in
xdiffusion_tpu/layers/attention.py. `SpatialCrossAttention`: GroupNorm (K3)
-> qkv Dense -> attention (K1, and K2 in its backward) -> zero-initialised
proj_out Dense -> dropout, added as a residual. With a `context_dim` it
cross-attends: the conditioning sequence (picked by `context_adapter`, else
context["text_embeddings"] or context["context_embedding"]), optionally
through a gain-only LayerNorm (eps 1e-5), goes through the `encoder_kv`
Dense, and its keys and values are concatenated before the image's, so
each of the H*W queries attends over L + H*W keys in the same K1 call.
`MultiHeadSelfAttention` (the DiT's and the GLIDE text transformer's): qkv
Dense with a bias, its three column slices straight into K1 (no copy),
proj Dense, dropout. Dropout
runs as in the residual block (layers/resnet.py): in training mode, with
`context["dropout_generator"]`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.config import instantiate_from_config
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm
from xdiffusion_tpu_torch.layers.resnet import (
    FastGroupNorm,
    dropout_generator,
    num_groups_for,
)
from xdiffusion_tpu_torch.ops.attention import attention_qkv
from xdiffusion_tpu_torch.utils import dropout


class SpatialCrossAttention(nn.Module):
    """Multi-head self- or cross-attention; heads = channels // dim_head
    unless dim_head == -1, when `heads` is used as given. The context
    adapter is built once here (the JAX package builds it at each call)."""

    def __init__(self, in_channels: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 is_causal: bool = False, context_key: str = "text_embeddings",
                 context_adapter: Optional[dict] = None, context_layer_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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
        self.cross = context_dim not in (None, -1)
        if self.cross:
            self.context_key = context_key
            self.context_adapter = (instantiate_from_config(dict(context_adapter))
                                    if context_adapter and "target" in context_adapter else None)
            self.context_norm = (LayerNorm(context_dim, eps=1e-5, use_bias=False, dtype=dtype)
                                 if context_layer_norm else None)
            self.encoder_kv = Dense(context_dim, 2 * c, dtype=dtype)
        self.proj_out = Dense(c, c, dtype=dtype, zero_init=True)

    def _encoder_kv(self, context: Dict):
        """The conditioning sequence's keys and values, (B, L, C) each."""
        if self.context_adapter is not None:
            enc = self.context_adapter(context)
        else:
            enc = context.get(self.context_key, context.get("context_embedding"))
        if enc is None:
            raise KeyError("cross-attention needs a context sequence")
        if self.context_norm is not None:
            enc = self.context_norm(enc)
        return self.encoder_kv(enc).chunk(2, dim=-1)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        hidden = self.norm(x).reshape(b, h * w, c)
        q, k, v = self.qkv(hidden).chunk(3, dim=-1)
        if self.cross and context is not None:
            ek, ev = self._encoder_kv(context)
            k, v = torch.cat([ek, k], dim=1), torch.cat([ev, v], dim=1)
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
