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

`RPENet`, `RPEAttention` and `FactorizedAttentionBlock` are Flexible
Diffusion Modeling's attention (the factorized 3-D UNet,
score_networks/unet_factorized3d.py), plain PyTorch as the JAX package
computes them with plain einsums; only the GroupNorm runs through K3.
`RPEAttention` takes tokens (B, D, T, C), D a folded free axis: GroupNorm
(no SiLU) on the (B*D, T, C) view, one qkv Dense, q scaled by hd^-0.5
before its logits and its relative-position key term, the relative-position
query term from k * scale transposed on its last two axes, the group mask
clip(observed + latent) (observed and latent frames attend among
themselves, pad slots among themselves), the softmax, the relative-position
value term on the probabilities, a zero-initialised proj_out, and the
residual onto the normed input, as the JAX module computes it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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


class RPENet(nn.Module):
    """Relative-position features conditioned on the diffusion time:
    (B, T, tdim) embeddings and (B, T, T) signed frame distances ->
    (B, T, T, heads, channels // heads). The distances enter as
    log1p(max(d, 0)), log1p(max(-d, 0)) and d == 0; `out` is
    zero-initialised."""

    def __init__(self, channels: int, num_heads: int, time_embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.embed_diffusion_time = Dense(time_embed_dim, channels)
        self.embed_distances = Dense(3, channels)
        self.out = Dense(channels, channels, zero_init=True)

    def forward(self, temb: torch.Tensor, relative_distances: torch.Tensor) -> torch.Tensor:
        rel = relative_distances.float()
        feats = torch.stack([torch.log1p(rel.clamp(min=0)), torch.log1p((-rel).clamp(min=0)),
                             (rel == 0).float()], dim=-1)
        emb = self.embed_diffusion_time(temb)[:, :, None] + self.embed_distances(feats)
        out = self.out(F.silu(emb))
        b, t = out.shape[:2]
        return out.reshape(b, t, t, self.num_heads, -1)


class RPEAttention(nn.Module):
    """Attention over T of tokens (B, D, T, C) with relative-position terms
    on q, k and v from `RPENet`s over explicit frame indices (module
    docstring). The lookup-table form (`use_rpe_net` False with a term on)
    raises, as in JAX."""

    def __init__(self, channels: int, num_heads: int, time_embed_dim: Optional[int] = None,
                 use_rpe_net: bool = False, use_rpe_q: bool = True, use_rpe_k: bool = True,
                 use_rpe_v: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.use_rpe = dict(q=use_rpe_q, k=use_rpe_k, v=use_rpe_v)
        if any(self.use_rpe.values()) and not use_rpe_net:
            raise NotImplementedError("lookup-table RPE is unused by the reference configs; "
                                      "use use_rpe_net=True")
        self.norm = FastGroupNorm(channels, num_groups_for(channels))
        self.qkv = Dense(channels, 3 * channels, dtype=dtype)
        for name in ("k", "q", "v"):
            if self.use_rpe[name]:
                self.add_module(f"rpe_{name}", RPENet(channels, num_heads, time_embed_dim))
        self.proj_out = Dense(channels, channels, dtype=dtype, zero_init=True)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                frame_indices: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, d, t, c = x.shape
        h = self.num_heads
        hidden = self.norm(x.reshape(b * d, t, c)).reshape(b, d, t, c)
        qkv = self.qkv(hidden).reshape(b, d, t, 3, h, c // h)
        q, k, v = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))  # (B, D, H, T, hd)
        scale = (c // h) ** -0.5
        q = q * scale
        attn = torch.einsum("bdhtf,bdhsf->bdhts", q.float(), k.float())
        rel = None
        if any(self.use_rpe.values()):
            if frame_indices is None:
                raise ValueError("RPE needs frame_indices")
            fi = frame_indices.to(device=x.device, dtype=torch.long)
            rel = fi[:, :, None] - fi[:, None, :]  # (B, T, T)
        if self.use_rpe["k"]:
            attn = attn + torch.einsum("bdhtf,btshf->bdhts", q, self.rpe_k(temb, rel))
        if self.use_rpe["q"]:
            attn = attn + torch.einsum("bdhtf,btshf->bdhts", k * scale,
                                       self.rpe_q(temb, rel)).transpose(-1, -2)
        if attn_mask is not None:
            m = attn_mask.to(device=x.device, dtype=torch.float32)
            allowed = m[:, None, :] * m[:, :, None] + (1 - m[:, None, :]) * (1 - m[:, :, None])
            attn = attn + torch.where(allowed > 0, 0.0, float("-inf"))[:, None, None]
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bdhts,bdhsf->bdhtf", attn, v)
        if self.use_rpe["v"]:
            out = out + torch.einsum("bdhts,btshf->bdhtf", attn, self.rpe_v(temb, rel))
        out = self.proj_out(out.transpose(2, 3).reshape(b, d, t, c))
        return hidden + out


class FactorizedAttentionBlock(nn.Module):
    """FDM's space-time attention on frame-folded maps (B*T, H, W, C):
    temporal `RPEAttention` over the T frames at each spatial position
    (frame indices, group mask), then spatial `RPEAttention` over the H*W
    positions of each frame with no relative positions and no mask."""

    def __init__(self, channels: int, num_heads: int, time_embed_dim: int,
                 use_rpe_net: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temporal_attention = RPEAttention(channels, num_heads, time_embed_dim,
                                               use_rpe_net=use_rpe_net, dtype=dtype)
        self.spatial_attention = RPEAttention(channels, num_heads, use_rpe_q=False,
                                              use_rpe_k=False, use_rpe_v=False, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, frame_indices: torch.Tensor,
                attn_mask: Optional[torch.Tensor], frames: int) -> torch.Tensor:
        bt, hh, ww, c = x.shape
        tokens = x.reshape(bt // frames, frames, hh * ww, c)
        temporal = self.temporal_attention(tokens.transpose(1, 2), temb=temb,
                                           frame_indices=frame_indices, attn_mask=attn_mask)
        spatial = self.spatial_attention(temporal.transpose(1, 2))
        return spatial.reshape(bt, hh, ww, c)
