"""Sana: the linear-attention diffusion transformer.

Counterpart of xdiffusion_tpu/score_networks/sana.py ("SANA: Efficient
High-Resolution Image Synthesis with Linear Diffusion Transformers",
arXiv:2410.10629): patchify (no position embedding: the Mix-FFN's depthwise
conv over the token grid carries position) -> N blocks of [ReLU linear
self-attention, softmax cross-attention to the caption, GLUMBConv Mix-FFN],
modulated adaLN-single style by one shared `t_block` plus a per-block
`scale_shift_table` -> the final table and the raw timestep embedding ->
linear unpatchify, in fp32.

Submodules carry the flax parameter paths (`block_{i}/qkv`,
`block_{i}/mix_ffn/conv_depth`, `caption_fc1`, `final_scale_shift_table`,
...), so the weight bridge (weights.py) maps a flax tree mechanically; the
depthwise conv's HWIO kernel (3, 3, 1, C) becomes the grouped OIHW weight
(C, 1, 3, 3).

The linear self-attention is plain PyTorch in fp32 with eps 1e-15, as the
JAX package's einsums (XLA runs them there, outside any Pallas kernel). The
cross-attention heads are `d // num_cross_attention_heads` wide (the
config's `cross_attention_head_dim` is not read, as in JAX): at the shipped
width two heads of 576 over 300 caption keys, through `dot_product_attention`
and so K5 (its gradient K6) on the card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import DiTTimestepEmbedding, PatchEmbed
from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.layers.norm import RMSNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import _layer_norm


def relu_linear_attention(q, k, v, eps: float = 1e-15) -> torch.Tensor:
    """q, k, v: (B, H, N, D). out = q (k^T v) / (q (k^T 1) + eps), in fp32
    on ReLU features."""
    q = F.relu(q).float()
    k = F.relu(k).float()
    v = v.float()
    kv = torch.einsum("bhnd,bhne->bhde", k, v)
    z = torch.einsum("bhnd,bhd->bhn", q, k.sum(dim=2))
    out = torch.einsum("bhnd,bhde->bhne", q, kv)
    return out / (z[..., None] + eps)


class GLUMBConv(nn.Module):
    """The gated mobile-inverted conv Mix-FFN on the (B, H, W, C) token grid:
    1x1 conv to 2 * hidden, SiLU, a depthwise 3x3 conv, the gate split
    (first half times SiLU of the second), a bias-free 1x1 conv;
    hidden = int(expand_ratio * C)."""

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: float = 2.5):
        super().__init__()
        hidden = int(expand_ratio * in_channels)
        self.conv_inverted = ConvNHWC(in_channels, 2 * hidden, 1)
        self.conv_depth = ConvNHWC(2 * hidden, 2 * hidden, 3, padding=1, groups=2 * hidden)
        self.conv_point = ConvNHWC(hidden, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        gate_in, gate = h.chunk(2, dim=-1)
        return self.conv_point(gate_in * F.silu(gate))


class SanaTransformerBlock(nn.Module):
    """Linear self-attention, softmax cross-attention and GLUMBConv, the
    first and last modulated by the shared signals plus this block's
    `scale_shift_table`; the cross-attention residual is not gated."""

    def __init__(self, dim: int, num_attention_heads: int, num_cross_attention_heads: int,
                 mlp_ratio: float = 2.5, grid=(4, 4)):
        super().__init__()
        self.dim = dim
        self.num_attention_heads = num_attention_heads
        self.num_cross_attention_heads = num_cross_attention_heads
        self.grid = tuple(grid)
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim ** 0.5)
        self.qkv = Dense(dim, 3 * dim, bias=False)
        self.attn_proj = Dense(dim, dim)
        self.cross_q = Dense(dim, dim)
        self.cross_kv = Dense(dim, 2 * dim)
        self.cross_proj = Dense(dim, dim)
        self.mix_ffn = GLUMBConv(dim, dim, expand_ratio=mlp_ratio)

    def forward(self, x: torch.Tensor, y: torch.Tensor, shared_mod: torch.Tensor) -> torch.Tensor:
        d = self.dim
        b, n, _ = x.shape
        mod = shared_mod + self.scale_shift_table[None]
        s1, sc1, g1, s2, sc2, g2 = mod.unbind(dim=1)

        def heads(t, count):  # (B, S, d) -> a (B, count, S, d / count) view
            return t.reshape(b, t.shape[1], count, d // count).transpose(1, 2)

        h = _layer_norm(x) * (1 + sc1[:, None]) + s1[:, None]
        q, k, v = (heads(t, self.num_attention_heads) for t in self.qkv(h).chunk(3, dim=-1))
        attn = relu_linear_attention(q, k, v).transpose(1, 2).reshape(b, n, d).to(x.dtype)
        x = x + g1[:, None] * self.attn_proj(attn)

        ck, cv = self.cross_kv(y).chunk(2, dim=-1)
        cross = dot_product_attention(heads(self.cross_q(x), self.num_cross_attention_heads),
                                      heads(ck, self.num_cross_attention_heads),
                                      heads(cv, self.num_cross_attention_heads))
        x = x + self.cross_proj(cross.transpose(1, 2).reshape(b, n, d))

        h = _layer_norm(x) * (1 + sc2[:, None]) + s2[:, None]
        gh, gw = self.grid
        h = self.mix_ffn(h.reshape(b, gh, gw, d))
        return x + g2[:, None] * h.reshape(b, n, d)


class SanaScoreNetwork(nn.Module):
    """Built from the score_network params block as a DotConfig; reads the
    caption sequence at context["text_embeddings"] (B, L,
    caption_channels) and the timestep at context["timestep"]."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._patch_size = p = int(cfg.patch_size)
        d = int(cfg.attention_head_dim) * int(cfg.num_attention_heads)
        self._dim = d
        self._is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        self._out_channels = (int(cfg.in_channels) * 2 if self._is_learned_sigma
                              else int(cfg.out_channels))
        s = cfg.input_spatial_size
        self._spatial = [s, s] if not isinstance(s, list) else list(s)
        self._grid = (self._spatial[0] // p, self._spatial[1] // p)
        caption = int(cfg.caption_channels)

        self.patch_embed = PatchEmbed(int(cfg.in_channels), p, d)
        self.t_embed = DiTTimestepEmbedding(d)
        self.t_block = Dense(d, 6 * d)
        self.caption_fc1 = Dense(caption, d)
        self.caption_fc2 = Dense(d, d)
        self.caption_norm = RMSNorm(d, eps=1e-5)
        self._blocks = []
        for i in range(int(cfg.num_layers)):
            block = SanaTransformerBlock(d, int(cfg.num_attention_heads),
                                         int(cfg.num_cross_attention_heads),
                                         mlp_ratio=float(cfg.mlp_ratio), grid=self._grid)
            self.add_module(f"block_{i}", block)
            self._blocks.append(block)
        self.final_scale_shift_table = nn.Parameter(torch.randn(2, d) / d ** 0.5)
        self.final_proj = Dense(d, p * p * self._out_channels, zero_init=True)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, out_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        b = x.shape[0]
        tokens = self.patch_embed(x)
        t_emb = self.t_embed(context["timestep"])
        shared_mod = self.t_block(F.silu(t_emb)).reshape(b, 6, self._dim)
        y = self.caption_fc2(F.gelu(self.caption_fc1(context["text_embeddings"]),
                                    approximate="tanh"))
        y = self.caption_norm(y)
        for block in self._blocks:
            tokens = block(tokens, y, shared_mod)
        fmod = self.final_scale_shift_table[None] + t_emb[:, None]
        shift, scale = fmod[:, 0], fmod[:, 1]
        tokens = _layer_norm(tokens) * (1 + scale[:, None]) + shift[:, None]
        tokens = self.final_proj(tokens)
        p, (gh, gw), oc = self._patch_size, self._grid, self._out_channels
        out = tokens.reshape(b, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, gh * p, gw * p, oc).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
