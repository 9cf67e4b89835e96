"""SD3's MMDiT: the dual-stream transformer with joint text-image attention.

Counterpart of `_modulate`, `TimestepTextEmbed`, `MMDiTBlock` and
`SD3Transformer2DModel` in xdiffusion_tpu/score_networks/sd3.py ("Scaling
Rectified Flow Transformers for High-Resolution Image Synthesis",
arXiv:2403.03206): image patches and the text sequence run as two streams
with their own adaLN-Zero modulations and weights, joined in every block
by one attention over [text; image]. The conditioning is the timestep
embedding plus the pooled text projection; the last block
(`context_pre_only`) drops the text stream.

Numerics and quirks as in the JAX package: every layer computes in fp32;
the norms are the affine-free LayerNorm (eps 1e-6); the GELU is the tanh
approximation; the time features are the cos-first GLIDE sinusoid of t
itself; the last block's text modulation and the final AdaLayerNormContinuous
emit (scale, shift), not (shift, scale); the sin-cos position table is
built at `pos_embed_max_size` with base size the token grid and
centre-cropped to it; the modulations and the output projection are
zero-initialised. With `qk_norm: rms_norm` (SD3.5) each head's q and k take
an RMSNorm before the joint attention. Every attention runs through
`dot_product_attention` on (B, H, S, D): K5 on the card, its gradient K6.

Submodules carry the names of the JAX package's flax parameter paths
(`pos_embed`, `time_text_embed`, `context_embedder`, `block_{i}`,
`final_mod`, `final_proj`). The JAX package's pipeline-parallel body (a
device-mesh feature) is not ported: the port runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import (
    PatchEmbed,
    glide_timestep_embedding,
    sincos_position_embedding_2d,
)
from xdiffusion_tpu_torch.layers.flux import heads
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import RMSNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import _layer_norm as layer_norm
from xdiffusion_tpu_torch.score_networks.dit import modulate


class TimestepTextEmbed(nn.Module):
    """MLP(sinusoid(t)) + MLP(pooled text)."""

    def __init__(self, embedding_dim: int, pooled_projection_dim: int):
        super().__init__()
        self.t_fc1 = Dense(256, embedding_dim)
        self.t_fc2 = Dense(embedding_dim, embedding_dim)
        self.p_fc1 = Dense(pooled_projection_dim, embedding_dim)
        self.p_fc2 = Dense(embedding_dim, embedding_dim)

    def forward(self, timestep: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        t = self.t_fc2(F.silu(self.t_fc1(glide_timestep_embedding(timestep.float(), 256))))
        return t + self.p_fc2(F.silu(self.p_fc1(pooled)))


class MMDiTBlock(nn.Module):
    """Dual-stream block with joint attention. `dual_attention` (SD3.5's
    MMDiT-X) adds a second image-only attention on norm_x1's output under its
    own modulation, whose residual lands before the MLP."""

    def __init__(self, dim: int, num_heads: int, context_pre_only: bool = False,
                 dual_attention: bool = False, qk_norm: bool = False):
        super().__init__()
        d = dim
        self.num_heads = num_heads
        self.context_pre_only = context_pre_only
        self.dual_attention = dual_attention
        self.qk_norm = qk_norm
        hd = d // num_heads
        self.mod_x = Dense(d, 6 * d, zero_init=True)
        self.mod_c = Dense(d, (2 if context_pre_only else 6) * d, zero_init=True)
        self.qkv_x = Dense(d, 3 * d)
        self.qkv_c = Dense(d, 3 * d)
        if qk_norm:
            self.q_norm, self.k_norm = RMSNorm(hd), RMSNorm(hd)
            self.c_q_norm, self.c_k_norm = RMSNorm(hd), RMSNorm(hd)
        self.proj_x = Dense(d, d)
        if dual_attention:
            self.mod_x2attn = Dense(d, 3 * d, zero_init=True)
            self.qkv_x2 = Dense(d, 3 * d)
            if qk_norm:
                self.q2_norm, self.k2_norm = RMSNorm(hd), RMSNorm(hd)
            self.proj_x2 = Dense(d, d)
        self.mlp_x1 = Dense(d, 4 * d)
        self.mlp_x2 = Dense(4 * d, d)
        if not context_pre_only:
            self.proj_c = Dense(d, d)
            self.mlp_c1 = Dense(d, 4 * d)
            self.mlp_c2 = Dense(4 * d, d)

    def _qkv(self, proj: nn.Module, h: torch.Tensor, q_norm: str, k_norm: str):
        q, k, v = (heads(t, self.num_heads) for t in proj(h).chunk(3, dim=-1))
        if self.qk_norm:
            q, k = getattr(self, q_norm)(q), getattr(self, k_norm)(k)
        return q, k, v

    @staticmethod
    def _mlp(fc1: nn.Module, fc2: nn.Module, h: torch.Tensor) -> torch.Tensor:
        return fc2(F.gelu(fc1(h), approximate="tanh"))

    def forward(self, x: torch.Tensor, c: torch.Tensor, temb: torch.Tensor):
        """x (B, N, D) image stream, c (B, L, D) text stream, temb (B, D) ->
        (x, c), c None after the last block."""
        b, n, d = x.shape
        length = c.shape[1]
        act = F.silu(temb)
        sx1, scx1, gx1, sx2, scx2, gx2 = self.mod_x(act).chunk(6, dim=-1)
        mc = self.mod_c(act).chunk(2 if self.context_pre_only else 6, dim=-1)
        norm_x1 = layer_norm(x)
        c_shift, c_scale = (mc[1], mc[0]) if self.context_pre_only else (mc[0], mc[1])
        qx, kx, vx = self._qkv(self.qkv_x, modulate(norm_x1, sx1, scx1), "q_norm", "k_norm")
        qc, kc, vc = self._qkv(self.qkv_c, modulate(layer_norm(c), c_shift, c_scale),
                               "c_q_norm", "c_k_norm")
        out = dot_product_attention(torch.cat([qc, qx], dim=2), torch.cat([kc, kx], dim=2),
                                    torch.cat([vc, vx], dim=2))
        out = out.transpose(1, 2).reshape(b, length + n, d)
        x = x + gx1[:, None] * self.proj_x(out[:, length:])
        if self.dual_attention:
            s2, sc2, g2 = self.mod_x2attn(act).chunk(3, dim=-1)
            q2, k2, v2 = self._qkv(self.qkv_x2, modulate(norm_x1, s2, sc2), "q2_norm", "k2_norm")
            attn2 = dot_product_attention(q2, k2, v2).transpose(1, 2).reshape(b, n, d)
            x = x + g2[:, None] * self.proj_x2(attn2)
        x = x + gx2[:, None] * self._mlp(self.mlp_x1, self.mlp_x2,
                                         modulate(layer_norm(x), sx2, scx2))
        if self.context_pre_only:
            return x, None
        c = c + mc[2][:, None] * self.proj_c(out[:, :length])
        c = c + mc[5][:, None] * self._mlp(self.mlp_c1, self.mlp_c2,
                                           modulate(layer_norm(c), mc[3], mc[4]))
        return x, c


class SD3Transformer2DModel(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._qk_norm = str(cfg.get("qk_norm", "")) == "rms_norm"
        self._dual_attention_layers = cfg.get("dual_attention_layers", ())
        self._patch_size = p = int(cfg.patch_size)
        self._num_heads = int(cfg.num_attention_heads)
        self._dim = d = self._num_heads * int(cfg.attention_head_dim)
        self._is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        self._out_channels = (int(cfg.in_channels) * 2 if self._is_learned_sigma
                              else int(cfg.out_channels))
        self.pos_embed = PatchEmbed(int(cfg.in_channels), p, d)
        grid = int(cfg.sample_size) // p
        max_size = int(cfg.get("pos_embed_max_size", 0) or grid)
        table = sincos_position_embedding_2d(d, max_size, max_size, base_size=grid)
        top = (max_size - grid) // 2
        self.register_buffer(
            "_pos_table",
            table.reshape(max_size, max_size, -1)[top:top + grid, top:top + grid]
            .reshape(grid * grid, -1).contiguous(),
            persistent=False)
        self.time_text_embed = TimestepTextEmbed(d, int(cfg.pooled_projection_dim))
        self.context_embedder = Dense(int(cfg.joint_attention_dim), d)
        n_layers = int(cfg.num_layers)
        self._blocks = []
        for i in range(n_layers):
            block = self._make_block(i, n_layers)
            self.add_module(f"block_{i}", block)
            self._blocks.append(block)
        self.final_mod = Dense(d, 2 * d, zero_init=True)
        self.final_proj = Dense(d, p * p * self._out_channels, zero_init=True)

    def _make_block(self, i: int, n_layers: int) -> MMDiTBlock:
        """SD3.5 (score_networks/sd35.py) overrides this to mix in MMDiT-X
        blocks."""
        return MMDiTBlock(self._dim, self._num_heads, context_pre_only=(i == n_layers - 1),
                          qk_norm=self._qk_norm)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, out_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        b, h, w, _ = x.shape
        tokens = self.pos_embed(x) + self._pos_table[None]
        temb = self.time_text_embed(context["timestep"], context["pooled_text_embeddings"])
        ctx = self.context_embedder(context["text_embeddings"])
        for block in self._blocks:
            tokens, ctx_new = block(tokens, ctx, temb)
            ctx = ctx_new if ctx_new is not None else ctx
        scale, shift = self.final_mod(F.silu(temb)).chunk(2, dim=-1)
        tokens = self.final_proj(modulate(layer_norm(tokens), shift, scale))
        p, c = self._patch_size, self._out_channels
        out = tokens.reshape(b, h // p, w // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, c).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
