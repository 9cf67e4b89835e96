"""Attention layers: over the spatial positions of an NHWC map (self or
cross), and over a token sequence.

Counterpart of `SpatialCrossAttention`, `MultiHeadSelfAttention`,
`TemporalSelfAttention` and `SpatialAndTemporalCrossAttention` in
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

`TemporalSelfAttention` (the video UNets' frame attention) is plain
PyTorch, as the JAX package computes it with plain einsums: GroupNorm (K3)
on the (B*H*W, F, C) view, a learned per-head relative-position key table
whose logits q . rel_k[j - i] add to q . k with no 1/sqrt(d) scaling, and
the output reshaped to (B*H*W, C, F) without a permute before proj_out, as
the original's kernel returns it (frames and head channels scramble; the
projection is trained against that layout). `rel_v_embeddings` is held and
unused, as there.
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


def _num_heads(c: int, heads: int, dim_head: int) -> int:
    """heads = channels // dim_head, or `heads` when dim_head == -1."""
    if dim_head == -1:
        return heads
    if c % dim_head != 0:
        raise ValueError(f"channels {c} not divisible by dim_head {dim_head}")
    return c // dim_head


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
        self.num_heads = _num_heads(c, heads, dim_head)
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


class TemporalSelfAttention(nn.Module):
    """Self-attention over the frame axis of a (B, F, H, W, C) video map,
    each spatial position's F frames a sequence, with relative-position key
    logits. Positions are arange(F), or context["frame_indices"] (B, >= F)
    when the context holds them (Flexible Diffusion Modeling's explicit
    frame indices); offsets clip to +-(max_relative_position - 1)."""

    def __init__(self, in_channels: int, temporal_sequence_length: int = 16,
                 max_relative_position: int = 16, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = in_channels
        self.num_heads = _num_heads(c, heads, dim_head)
        head_dim = c // self.num_heads
        self.max_relative_position = max_relative_position
        self.dropout = dropout
        self.norm = FastGroupNorm(c, num_groups_for(c))
        self.qkv = Dense(c, 3 * c, dtype=dtype)
        table = (self.num_heads, 2 * max_relative_position - 1, head_dim)
        self.rel_k_embeddings = nn.Parameter(torch.randn(table) * head_dim ** -0.5)
        self.rel_v_embeddings = nn.Parameter(torch.randn(table) * head_dim ** -0.5)
        self.proj_out = Dense(c, c, dtype=dtype, zero_init=True)

    def _offsets(self, f: int, spatial: int, context: Optional[Dict], device):
        """Index j - i + (M - 1) into the table: (F, F), or (B*H*W, F, F)
        from explicit frame indices."""
        m = self.max_relative_position
        if context is not None and "frame_indices" in context:
            fi = context["frame_indices"][:, :f].to(device=device, dtype=torch.long)
            rel = fi[:, None, :] - fi[:, :, None]
            return (rel.clamp(-(m - 1), m - 1) + (m - 1)).repeat_interleave(spatial, dim=0)
        idx = torch.arange(f, device=device)
        return (idx[None, :] - idx[:, None]).clamp(-(m - 1), m - 1) + (m - 1)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        b, f, h, w, c = x.shape
        n, heads = b * h * w, self.num_heads
        hidden = self.norm(x.permute(0, 2, 3, 1, 4).reshape(n, f, c))
        q, k, v = (t.reshape(n, f, heads, c // heads).transpose(1, 2)
                   for t in self.qkv(hidden).chunk(3, dim=-1))
        # q . rel_k[r] for every offset r, then each (i, j) picks its offset's.
        per_offset = torch.einsum("bhqd,hrd->bhqr", q.float(), self.rel_k_embeddings.float())
        rel = self._offsets(f, h * w, context, x.device)
        rel = rel.expand(n, f, f) if rel.ndim == 2 else rel
        rel_logits = torch.gather(per_offset, 3, rel[:, None].expand(n, heads, f, f))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + rel_logits
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        out = self.proj_out(out.reshape(n, c, f).transpose(1, 2))
        generator = dropout_generator(self, context)
        if generator is not None:
            out = dropout(out, self.dropout, generator)
        return x + out.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)


class SpatialAndTemporalCrossAttention(nn.Module):
    """Make-A-Video's fused block on frame-folded (B*F, H, W, C) maps:
    `SpatialCrossAttention` (`spatial`), then, with `is_video`, the frames
    recovered from `temporal_sequence_length` go through
    `TemporalSelfAttention` (`temporal`) without the context (only its
    dropout generator)."""

    def __init__(self, in_channels: int, temporal_sequence_length: int = 16,
                 max_relative_position: int = 16, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 is_video: bool = True, pre_layer_norm: bool = False,
                 post_layer_norm: bool = False, context_layer_norm: bool = False,
                 context_adapter: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frames = temporal_sequence_length
        self.is_video = is_video
        self.spatial = SpatialCrossAttention(
            in_channels, context_dim=context_dim, heads=heads, dim_head=dim_head,
            dropout=dropout, context_adapter=context_adapter,
            context_layer_norm=context_layer_norm, dtype=dtype)
        self.temporal = TemporalSelfAttention(
            in_channels, temporal_sequence_length=temporal_sequence_length,
            max_relative_position=max_relative_position, heads=heads, dim_head=dim_head,
            dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        x = self.spatial(x, context)
        if not self.is_video:
            return x
        bf, h, w, c = x.shape
        generator = None if context is None else context.get("dropout_generator")
        video = self.temporal(x.reshape(bf // self.frames, self.frames, h, w, c),
                              None if generator is None else {"dropout_generator": generator})
        return video.reshape(bf, h, w, c)
