"""AuraFlow: MMDiT joint blocks, then single-DiT blocks over the joint tokens.

Counterpart of `_fp32_ln`, `AuraFlowFeedForward`, `_ada_zero`, `_qk_heads`,
`AuraFlowJointBlock`, `AuraFlowSingleBlock` and `AuraFlow` in
xdiffusion_tpu/score_networks/auraflow.py. Its quirks, kept:

- no bias anywhere but the patch projection and the time MLP;
- each head's q and k take an affine-free fp32 LayerNorm (eps 1e-5) before
  the [text; image] concat;
- the feed-forward is SwiGLU, silu(linear_1(x)) * linear_2(x) ->
  out_projection, with a hidden width of 2 * 4d / 3 rounded up to 256;
- sandwich residuals: the second norm wraps the post-attention sum, and the
  feed-forward's residual is the pre-attention input;
- a learned (1, pos_embed_max_size, d) position table, centre-cropped to
  the token grid, over channel-first patch features;
- 8 learned register tokens ahead of the text: [registers; text; image];
- the final modulation, with no norm, emits (scale, shift).

Every attention runs through `dot_product_attention` on (B, H, S, D) with
the scale head_dim ** -0.5: K5 on the card (at the shipped config's head
dim 256 its wide variant), its gradient K6. Submodules carry the names of
the JAX package's flax parameter paths (`patch_proj`, `pos_embed`,
`context_embedder`, `t_fc1`, `t_fc2`, `register_tokens`, `mmdit_{i}`,
`single_{i}`, `final_mod`, `final_proj`).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import modulate


def fp32_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free LayerNorm over the last axis, computed in fp32, returned
    in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def _find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


class AuraFlowFeedForward(nn.Module):
    """Bias-free SwiGLU MLP."""

    def __init__(self, dim: int):
        super().__init__()
        hidden = _find_multiple(int(2 * (4 * dim) / 3), 256)
        self.linear_1 = Dense(dim, hidden, bias=False)
        self.linear_2 = Dense(dim, hidden, bias=False)
        self.out_projection = Dense(hidden, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_projection(F.silu(self.linear_1(x)) * self.linear_2(x))


def _ada_zero(d: int) -> Dense:
    """AdaLayerNormZero's bias-free 6-way modulation linear (on SiLU(temb))."""
    return Dense(d, 6 * d, bias=False)


def _qk_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, H, C // H)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads)


def _attention(q, k, v) -> torch.Tensor:
    """(B, S, H, D) q, k, v -> (B, S, H * D), q and k fp32-LayerNormed per
    head."""
    b, s, h, hd = q.shape
    out = dot_product_attention(fp32_layer_norm(q).transpose(1, 2),
                                fp32_layer_norm(k).transpose(1, 2), v.transpose(1, 2),
                                scale=hd ** -0.5)
    return out.transpose(1, 2).reshape(b, s, h * hd)


class AuraFlowJointBlock(nn.Module):
    """MMDiT-style joint block: one attention over [text; image]."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.mod_x, self.mod_c = _ada_zero(dim), _ada_zero(dim)
        self.qkv_x = Dense(dim, 3 * dim, bias=False)
        self.qkv_c = Dense(dim, 3 * dim, bias=False)
        self.proj_x = Dense(dim, dim, bias=False)
        self.proj_c = Dense(dim, dim, bias=False)
        self.ff_x = AuraFlowFeedForward(dim)
        self.ff_c = AuraFlowFeedForward(dim)

    def forward(self, x, c, temb):
        length = c.shape[1]
        act = F.silu(temb)
        sx, scx, gx, sx2, scx2, gx2 = self.mod_x(act).chunk(6, dim=-1)
        sc_, scc, gc, sc2, scc2, gc2 = self.mod_c(act).chunk(6, dim=-1)
        qx, kx, vx = (_qk_heads(t, self.num_heads) for t in
                      self.qkv_x(modulate(fp32_layer_norm(x), sx, scx)).chunk(3, dim=-1))
        qc, kc, vc = (_qk_heads(t, self.num_heads) for t in
                      self.qkv_c(modulate(fp32_layer_norm(c), sc_, scc)).chunk(3, dim=-1))
        out = _attention(torch.cat([qc, qx], dim=1), torch.cat([kc, kx], dim=1),
                         torch.cat([vc, vx], dim=1))
        out_x, out_c = self.proj_x(out[:, length:]), self.proj_c(out[:, :length])
        hx = modulate(fp32_layer_norm(x + gx[:, None] * out_x), sx2, scx2)
        hc = modulate(fp32_layer_norm(c + gc[:, None] * out_c), sc2, scc2)
        return x + gx2[:, None] * self.ff_x(hx), c + gc2[:, None] * self.ff_c(hc)


class AuraFlowSingleBlock(nn.Module):
    """The single-DiT block over the merged tokens."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.mod = _ada_zero(dim)
        self.qkv = Dense(dim, 3 * dim, bias=False)
        self.proj = Dense(dim, dim, bias=False)
        self.ff = AuraFlowFeedForward(dim)

    def forward(self, x, temb):
        s1, sc1, g1, s2, sc2, g2 = self.mod(F.silu(temb)).chunk(6, dim=-1)
        q, k, v = (_qk_heads(t, self.num_heads) for t in
                   self.qkv(modulate(fp32_layer_norm(x), s1, sc1)).chunk(3, dim=-1))
        out = self.proj(_attention(q, k, v))
        h = modulate(fp32_layer_norm(x + g1[:, None] * out), s2, sc2)
        return x + g2[:, None] * self.ff(h)


class AuraFlow(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._patch_size = p = int(cfg.patch_size)
        self._num_heads = int(cfg.num_attention_heads)
        self._dim = d = int(cfg.attention_head_dim) * self._num_heads
        self._is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        in_channels = int(cfg.input_channels)
        self._out_channels = in_channels * 2 if self._is_learned_sigma else int(cfg.out_channels)
        self._pos_embed_max_size = int(cfg.get("pos_embed_max_size", 1024))
        self.patch_proj = Dense(in_channels * p * p, d)
        self.pos_embed = nn.Parameter(0.1 * torch.randn(1, self._pos_embed_max_size, d))
        self.context_embedder = Dense(int(cfg.joint_attention_dim), d, bias=False)
        self.t_fc1 = Dense(256, d)
        self.t_fc2 = Dense(d, d)
        self.register_tokens = nn.Parameter(0.02 * torch.randn(1, 8, d))
        self._mmdit_blocks, self._single_blocks = [], []
        for i in range(int(cfg.num_mmdit_layers)):
            block = AuraFlowJointBlock(d, self._num_heads)
            self.add_module(f"mmdit_{i}", block)
            self._mmdit_blocks.append(block)
        for i in range(int(cfg.num_single_dit_layers)):
            block = AuraFlowSingleBlock(d, self._num_heads)
            self.add_module(f"single_{i}", block)
            self._single_blocks.append(block)
        self.final_mod = Dense(d, 2 * d, bias=False)
        self.final_proj = Dense(d, p * p * self._out_channels, bias=False)

    def _pe_selection(self, gh: int, gw: int) -> torch.Tensor:
        """The position table's rows of the centre gh x gw window of its
        square grid."""
        h_max = math.isqrt(self._pos_embed_max_size)
        top, left = h_max // 2 - gh // 2, h_max // 2 - gw // 2
        idx = torch.arange(self._pos_embed_max_size).reshape(h_max, h_max)
        return idx[top:top + gh, left:left + gw].reshape(-1)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, out_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        b, h, w, c = x.shape
        p = self._patch_size
        gh, gw = h // p, w // p
        # Channel-first patch features: (B, C, gh, p, gw, p) -> (B, N, C*p*p).
        tokens = x.permute(0, 3, 1, 2).reshape(b, c, gh, p, gw, p)
        tokens = tokens.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * p * p)
        tokens = (self.patch_proj(tokens)
                  + self.pos_embed[:, self._pe_selection(gh, gw).to(x.device)])
        temb = self.t_fc2(F.silu(self.t_fc1(glide_timestep_embedding(
            context["timestep"].float(), 256, scale=1000.0))))
        ctx = self.context_embedder(context["t5_text_embeddings"])
        ctx = torch.cat([self.register_tokens.expand(b, -1, -1), ctx], dim=1)
        for block in self._mmdit_blocks:
            tokens, ctx = block(tokens, ctx, temb)
        merged = torch.cat([ctx, tokens], dim=1)
        for block in self._single_blocks:
            merged = block(merged, temb)
        tokens = merged[:, ctx.shape[1]:]
        scale, shift = self.final_mod(F.silu(temb)).chunk(2, dim=-1)
        tokens = self.final_proj(modulate(tokens, shift, scale))
        oc = self._out_channels
        out = tokens.reshape(b, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, oc).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
