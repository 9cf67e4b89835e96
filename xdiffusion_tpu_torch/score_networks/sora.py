"""Sora (OpenSora's STDiT3): the spatial-temporal diffusion transformer.

Counterpart of `_rotary`, `STAttention`, `CaptionCrossAttention`,
`STDiTBlock` and `Sora` in xdiffusion_tpu/score_networks/sora.py: a 3-D
patchify (pt, ph, pw) of the (B, F, H, W, C) video, a fixed 2-D sin-cos
position table tiled over the frames, then `depth` pairs of [spatial block
(attention within each frame), temporal block (attention across the frames
at each location, its q and k rotated over the frame axis)], each
modulated by its own `scale_shift_table` plus one shared projection
(`t_block`) of the timestep embedding, with cross-attention to the caption
in every block; the final layer's shift and scale are
`final_scale_shift_table` plus the raw timestep embedding, and the output
unpatchifies channel-last.

A context `video_mask` (B, F) (True: generate the frame) modulates the
conditioned frames (False) with the timestep-zero embedding in every block
and in the final layer, when the patch takes one frame (pt == 1). The
final layer keeps the JAX package's quirk: its zero branch modulates the
re-normed, already t-modulated tokens.

Attention: spatial and temporal self-attention and the caption
cross-attention go through `dot_product_attention` on (B, H, S, D), so K5
(its gradient K6) on the card; at sora.yaml's size and batch 8 that is
(128, 6, 64, 64) spatial, (512, 6, 16, 16) temporal and (8, 6, 1024, 120)
caption calls, 48 a forward. With a `text_attention_mask` the caption
attention runs plain einsums with a finfo.min bias, as JAX does (the hash
T5 embedder gives no mask).

Submodules carry the names of the JAX package's flax parameter paths
(`x_embedder`, `t_fc1`, `t_fc2`, `t_block`, `y_fc1`, `y_fc2`,
`spatial_{i}` and `temporal_{i}` with `attn/{qkv,q_norm,k_norm,proj}`,
`cross_attn/{q,kv,proj}`, `mlp1`, `mlp2`, `scale_shift_table`;
`final_proj`, `final_scale_shift_table`), so the weight bridge
(weights.py) maps a flax tree onto this module mechanically. Every layer
computes in fp32, as the JAX module does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import (
    glide_timestep_embedding,
    sincos_position_embedding_2d,
)
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import RMSNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import _layer_norm


def _t2i_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale) + shift


def rotary(t: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over the sequence axis of a (B, H, N, D) tensor:
    interleaved pairs, frequencies 1 / 10000^(2i / D), in fp32. An odd D
    rotates the first 2 * (D // 2) channels and passes the last through."""
    n, d = t.shape[-2], t.shape[-1]
    half = d // 2
    base = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=t.device)[:half]
                              / d))
    f = torch.arange(n, dtype=torch.float32, device=t.device)[:, None] * base[None]
    cos = torch.cos(f).repeat_interleave(2, dim=-1)
    sin = torch.sin(f).repeat_interleave(2, dim=-1)
    head, tail = t[..., :2 * half], t[..., 2 * half:]
    x = head.reshape(*head.shape[:-1], half, 2)
    rot = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(head.shape)
    return torch.cat([head * cos + rot * sin, tail], dim=-1).to(t.dtype)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H * D) -> a (B, H, L, D) view."""
    b, length, c = t.shape
    return t.reshape(b, length, num_heads, c // num_heads).transpose(1, 2)


class STAttention(nn.Module):
    """Self-attention with an optional per-head RMS qk-norm and rotary
    embedding over the sequence (the temporal blocks' frame axis)."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = True, rope: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.rope = rope
        self.qkv = Dense(dim, 3 * dim)
        self.q_norm = RMSNorm(dim // num_heads) if qk_norm else None
        self.k_norm = RMSNorm(dim // num_heads) if qk_norm else None
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = (_heads(t, self.num_heads) for t in self.qkv(x).chunk(3, dim=-1))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope:
            q, k = rotary(q), rotary(k)
        out = dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CaptionCrossAttention(nn.Module):
    """Tokens (B, N, C) attend to the caption (B, L, C); a `text_mask` (B,
    L) (nonzero: a real token) masks padded caption tokens out through
    plain einsums, as the JAX package does; without one, K5."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim)
        self.kv = Dense(dim, 2 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        k, v = self.kv(y).chunk(2, dim=-1)
        qh, kh, vh = (_heads(t, self.num_heads) for t in (self.q(x), k, v))
        if text_mask is not None:
            logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * (hd ** -0.5)
            bias = torch.where(text_mask[:, None, None, :].bool(), 0.0,
                               torch.finfo(torch.float32).min)
            w = torch.softmax(logits + bias, dim=-1).to(vh.dtype)
            out = torch.einsum("bhqk,bhkd->bhqd", w, vh)
        else:
            out = dot_product_attention(qh, kh, vh)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class STDiTBlock(nn.Module):
    """One spatial or temporal STDiT3 block: its `scale_shift_table` plus
    the shared `t_block` signals modulate the attention and the MLP (each
    frame by t or, where the frame mask says conditioned, by t = 0), with
    caption cross-attention between them."""

    def __init__(self, hidden_size: int, num_heads: int, temporal: bool = False,
                 mlp_ratio: float = 4.0, qk_norm: bool = True, rope: bool = False):
        super().__init__()
        d = hidden_size
        self.temporal = temporal
        self.scale_shift_table = nn.Parameter(torch.randn(6, d) * d ** -0.5)
        self.attn = STAttention(d, num_heads, qk_norm=qk_norm, rope=rope)
        self.cross_attn = CaptionCrossAttention(d, num_heads)
        self.mlp1 = Dense(d, int(d * mlp_ratio))
        self.mlp2 = Dense(int(d * mlp_ratio), d)

    def forward(self, x: torch.Tensor, y: torch.Tensor, t6: torch.Tensor, num_frames: int,
                t6_zero: Optional[torch.Tensor] = None,
                frame_mask: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, F*N, D); t6, t6_zero (B, 6*D); frame_mask (B, F), True =
        generate (t), False = conditioned (t0)."""
        b, fn, d = x.shape
        f = num_frames
        n = fn // f

        def mods(t_vec):  # six (B, 1, D) signals
            return (self.scale_shift_table[None] + t_vec.reshape(b, 6, d))[:, :, None].unbind(1)

        s1, sc1, g1, s2, sc2, g2 = mods(t6)
        masked = frame_mask is not None and t6_zero is not None
        if masked:
            z1, zc1, zg1, z2, zc2, zg2 = mods(t6_zero)
            sel = frame_mask[:, :, None, None].bool()

            def frame_select(a, a_zero):
                return torch.where(sel, a.reshape(b, f, n, d),
                                   a_zero.reshape(b, f, n, d)).reshape(b, fn, d)

        h = _layer_norm(x)
        hm = _t2i_modulate(h, s1, sc1)
        if masked:
            hm = frame_select(hm, _t2i_modulate(h, z1, zc1))
        if self.temporal:
            # (B, F, N, D) -> (B*N, F, D): the frames attend at each location.
            hm = hm.reshape(b, f, n, d).transpose(1, 2).reshape(b * n, f, d)
            hm = self.attn(hm).reshape(b, n, f, d).transpose(1, 2).reshape(b, fn, d)
        else:
            # (B*F, N, D): attention within each frame.
            hm = self.attn(hm.reshape(b * f, n, d)).reshape(b, fn, d)
        gated = g1 * hm
        if masked:
            gated = frame_select(gated, zg1 * hm)
        x = x + gated
        x = x + self.cross_attn(x, y, text_mask)
        h = _layer_norm(x)
        hm = _t2i_modulate(h, s2, sc2)
        if masked:
            hm = frame_select(hm, _t2i_modulate(h, z2, zc2))
        hm = self.mlp2(F.gelu(self.mlp1(hm), approximate="tanh"))
        gated = g2 * hm
        if masked:
            gated = frame_select(gated, zg2 * hm)
        return x + gated


class Sora(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._patch = tuple(int(p) for p in cfg.patch_size)  # (pt, ph, pw)
        d = int(cfg.hidden_size)
        self._dim = d
        self._num_heads = int(cfg.num_heads)
        self._is_learned_sigma = bool(cfg.get("pred_sigma", False))
        in_channels = int(cfg.input_channels)
        self._out_channels = in_channels * (2 if self._is_learned_sigma else 1)
        size = [int(s) for s in cfg.input_size]  # (F, H, W)
        pt, ph, pw = self._patch
        grid = (size[0] // pt, size[1] // ph, size[2] // pw)

        self.x_embedder = Dense(in_channels * pt * ph * pw, d)
        # Positions scaled by base_size / grid and divided by
        # sqrt(H * W) / input_sq_size, as the JAX package builds them.
        res_sq = math.sqrt(float(size[1]) * float(size[2]))
        pos_scale = res_sq / float(cfg.get("input_sq_size", res_sq))
        self.register_buffer(
            "_pos_spatial",
            sincos_position_embedding_2d(d, grid[1], grid[2],
                                         base_size=round((grid[1] * grid[2]) ** 0.5),
                                         lewei_scale=pos_scale),
            persistent=False)
        self.t_fc1 = Dense(256, d)
        self.t_fc2 = Dense(d, d)
        self.t_block = Dense(d, 6 * d)  # the six signals every block shares
        self.y_fc1 = Dense(int(cfg.caption_channels), d)
        self.y_fc2 = Dense(d, d)
        self._blocks = []
        qk_norm = bool(cfg.get("qk_norm", True))
        for i in range(int(cfg.depth)):
            spatial = STDiTBlock(d, self._num_heads, temporal=False,
                                 mlp_ratio=float(cfg.mlp_ratio), qk_norm=qk_norm)
            temporal = STDiTBlock(d, self._num_heads, temporal=True,
                                  mlp_ratio=float(cfg.mlp_ratio), qk_norm=qk_norm, rope=True)
            self.add_module(f"spatial_{i}", spatial)
            self.add_module(f"temporal_{i}", temporal)
            self._blocks.append((spatial, temporal))
        self.final_proj = Dense(d, pt * ph * pw * self._out_channels, zero_init=True)
        self.final_scale_shift_table = nn.Parameter(torch.randn(2, d) * d ** -0.5)

    def _temb(self, timestep: torch.Tensor) -> torch.Tensor:
        # The DiT timestep features: cos first, a `half` divisor, raw times.
        return self.t_fc2(F.silu(self.t_fc1(glide_timestep_embedding(timestep, 256))))

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C) -> (B, F, H, W, C out) fp32, or the pair
        (prediction, log-variance) with `pred_sigma`."""
        b, f, hh, ww, c = x.shape
        pt, ph, pw = self._patch
        gf, gh, gw = f // pt, hh // ph, ww // pw
        d = self._dim

        tokens = x.reshape(b, gf, pt, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        tokens = self.x_embedder(tokens.reshape(b, gf * gh * gw, c * pt * ph * pw))
        tokens = tokens + self._pos_spatial.repeat(gf, 1)[None]

        timestep = context["timestep"].float()
        temb = self._temb(timestep)
        t6 = self.t_block(F.silu(temb))
        y = context["text_embeddings"]
        if y.ndim == 4:  # the reference layout (B, 1, L, C)
            y = y[:, 0]
        y = self.y_fc2(F.gelu(self.y_fc1(y), approximate="tanh"))
        text_mask = context.get("text_attention_mask")

        # The frame mask (True: generate) applies when a patch is one frame.
        frame_mask = t6_zero = temb_zero = None
        vm = context.get("video_mask")
        if vm is not None and pt == 1:
            frame_mask = vm[:, :gf]
            temb_zero = self._temb(torch.zeros_like(timestep))
            t6_zero = self.t_block(F.silu(temb_zero))

        for spatial, temporal in self._blocks:
            tokens = spatial(tokens, y, t6, gf, t6_zero=t6_zero, frame_mask=frame_mask,
                             text_mask=text_mask)
            tokens = temporal(tokens, y, t6, gf, t6_zero=t6_zero, frame_mask=frame_mask,
                              text_mask=text_mask)

        def final_mod(t_vec):  # table rows: shift, scale
            m = self.final_scale_shift_table[None] + t_vec.reshape(b, 1, d)
            return m[:, 0][:, None], m[:, 1][:, None]

        shift, scale = final_mod(temb)
        out_tokens = _t2i_modulate(_layer_norm(tokens), shift, scale)
        if frame_mask is not None:
            z_shift, z_scale = final_mod(temb_zero)
            # The JAX package's quirk, kept: the zero branch modulates the
            # re-normed, already t-modulated tokens.
            alt = _t2i_modulate(_layer_norm(out_tokens), z_shift, z_scale)
            sel = frame_mask[:, :, None, None].bool()
            n_sp = gh * gw
            out_tokens = torch.where(sel, out_tokens.reshape(b, gf, n_sp, d),
                                     alt.reshape(b, gf, n_sp, d)).reshape(b, gf * n_sp, d)
        tokens = self.final_proj(out_tokens)

        oc = self._out_channels
        out = tokens.reshape(b, gf, gh, gw, pt, ph, pw, oc).permute(0, 1, 4, 2, 5, 3, 6, 7)
        out = out.reshape(b, f, hh, ww, oc).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
