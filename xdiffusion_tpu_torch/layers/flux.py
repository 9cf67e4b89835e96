"""Flux building blocks: multi-axis RoPE, qk-norm joint attention, the
double- and single-stream blocks and the final layer.

Counterpart of `rope_frequencies`, `apply_rope`, `rope_attention`,
`MLPEmbedder`, `_norm`, `_qk_norm`, `Modulation`, `DoubleStreamBlock`,
`SingleStreamBlock` and `LastLayer` in xdiffusion_tpu/layers/flux.py.

Rotary tables are built per position from 3-axis ids in fp32 and rotate
interleaved pairs (channels 0::2 with 1::2). Double-stream blocks keep
separate image and text weights and join the streams in one attention over
[text; image]; single-stream blocks compute attention and the MLP in
parallel from one fused projection. Every attention goes through
`dot_product_attention` on (B, H, S, D): K5 (its gradient K6) on the card.
`norm_cls="dyt"` swaps every norm, the qk norms included, for DyT; the
norms and the modulation are PixArt's and the DiT's (flax's affine-free
LayerNorm, eps 1e-6, or DyT).

Submodules carry the names of the JAX package's flax parameter paths, so
the weight bridge (weights.py) maps a flax tree onto them mechanically.
Every layer computes in fp32, as the JAX modules do with their default
dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import DynamicTanhNorm, RMSNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import modulate
from xdiffusion_tpu_torch.score_networks.pixart import _apply_norm as apply_norm
from xdiffusion_tpu_torch.score_networks.pixart import _norm as make_norm


def rope_frequencies(ids: torch.Tensor, axes_dim: Sequence[int], theta: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (B, L, n_axes) -> fp32 cos and sin tables (B, L, sum(axes_dim) // 2):
    axis i contributes axes_dim[i] // 2 frequency pairs."""
    cos_parts, sin_parts = [], []
    for i, dim in enumerate(axes_dim):
        half = dim // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=ids.device)
                                 * 2.0 / dim))
        angles = ids[..., i:i + 1].float() * freqs[None, None, :]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, L, D), cos and sin (B, L, D // 2): each pair (x[2i], x[2i+1])
    rotated by its angle; contiguous (B, H, L, D)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def rope_attention(q, k, v, cos, sin) -> torch.Tensor:
    """Attention of the rotated q and k over v, (B, H, S, D)."""
    return dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)


class MLPEmbedder(nn.Module):
    """in_layer -> SiLU -> out_layer."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = Dense(in_dim, hidden_dim)
        self.out_layer = Dense(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


def make_qk_norm(norm_cls: str, dim: int) -> nn.Module:
    """The per-head query or key norm: RMSNorm, or DyT in flux_dyt."""
    return DynamicTanhNorm(dim) if norm_cls == "dyt" else RMSNorm(dim)


class Modulation(nn.Module):
    """`lin` (zero-initialised) on SiLU(vec), split into 6 (double) or 3
    signals of width dim."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Dense(dim, self.mult * dim, zero_init=True)

    def forward(self, vec: torch.Tensor):
        return self.lin(F.silu(vec)).chunk(self.mult, dim=-1)


def heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H * D) -> a (B, H, L, D) view."""
    b, length, c = t.shape
    return t.reshape(b, length, num_heads, c // num_heads).transpose(1, 2)


class DoubleStreamBlock(nn.Module):
    """Separate image and text streams joined in one RoPE attention over
    [text; image]."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, norm_cls: str = "layernorm"):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        hd = d // num_heads
        mlp = int(d * mlp_ratio)
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", Modulation(d, double=True))
            self.add_module(f"{s}_norm1", make_norm(norm_cls, d))
            self.add_module(f"{s}_qkv", Dense(d, 3 * d, bias=qkv_bias))
            self.add_module(f"{s}_q_norm", make_qk_norm(norm_cls, hd))
            self.add_module(f"{s}_k_norm", make_qk_norm(norm_cls, hd))
            self.add_module(f"{s}_proj", Dense(d, d))
            self.add_module(f"{s}_norm2", make_norm(norm_cls, d))
            self.add_module(f"{s}_mlp1", Dense(d, mlp))
            self.add_module(f"{s}_mlp2", Dense(mlp, d))

    def _qkv(self, s: str, x: torch.Tensor, shift, scale):
        h = modulate(apply_norm(getattr(self, f"{s}_norm1"), x), shift, scale)
        q, k, v = (heads(t, self.num_heads) for t in getattr(self, f"{s}_qkv")(h).chunk(3, -1))
        return getattr(self, f"{s}_q_norm")(q), getattr(self, f"{s}_k_norm")(k), v

    def _residual(self, s: str, x, attn, gate1, shift2, scale2, gate2):
        x = x + gate1[:, None] * getattr(self, f"{s}_proj")(attn)
        h = modulate(apply_norm(getattr(self, f"{s}_norm2"), x), shift2, scale2)
        h = getattr(self, f"{s}_mlp2")(F.gelu(getattr(self, f"{s}_mlp1")(h), approximate="tanh"))
        return x + gate2[:, None] * h

    def forward(self, img, txt, vec, cos, sin):
        b, n_img, d = img.shape
        n_txt = txt.shape[1]
        im1, is1, ig1, im2, is2, ig2 = self.img_mod(vec)
        tm1, ts1, tg1, tm2, ts2, tg2 = self.txt_mod(vec)
        iq, ik, iv = self._qkv("img", img, im1, is1)
        tq, tk, tv = self._qkv("txt", txt, tm1, ts1)
        attn = rope_attention(torch.cat([tq, iq], dim=2), torch.cat([tk, ik], dim=2),
                              torch.cat([tv, iv], dim=2), cos, sin)
        attn = attn.transpose(1, 2).reshape(b, n_txt + n_img, d)
        img = self._residual("img", img, attn[:, n_txt:], ig1, im2, is2, ig2)
        txt = self._residual("txt", txt, attn[:, :n_txt], tg1, tm2, ts2, tg2)
        return img, txt


class SingleStreamBlock(nn.Module):
    """The merged sequence: attention and MLP in parallel from one fused
    projection (`linear1`), joined by `linear2`."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_cls: str = "layernorm"):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.mlp_dim = int(d * mlp_ratio)
        self.modulation = Modulation(d, double=False)
        self.pre_norm = make_norm(norm_cls, d)
        self.linear1 = Dense(d, 3 * d + self.mlp_dim)
        self.q_norm = make_qk_norm(norm_cls, d // num_heads)
        self.k_norm = make_qk_norm(norm_cls, d // num_heads)
        self.linear2 = Dense(d + self.mlp_dim, d)

    def forward(self, x, vec, cos, sin):
        b, n, d = x.shape
        shift, scale, gate = self.modulation(vec)
        fused = self.linear1(modulate(apply_norm(self.pre_norm, x), shift, scale))
        q, k, v = (heads(t, self.num_heads) for t in fused[..., :3 * d].chunk(3, -1))
        attn = rope_attention(self.q_norm(q), self.k_norm(k), v, cos, sin)
        attn = attn.transpose(1, 2).reshape(b, n, d)
        mlp = F.gelu(fused[..., 3 * d:], approximate="tanh")
        return x + gate[:, None] * self.linear2(torch.cat([attn, mlp], dim=-1))


class LastLayer(nn.Module):
    """adaLN (`mod`, zero-initialised: shift, then scale) and the
    zero-initialised output projection `proj`."""

    def __init__(self, hidden_size: int, out_dim: int, norm_cls: str = "layernorm"):
        super().__init__()
        self.mod = Dense(hidden_size, 2 * hidden_size, zero_init=True)
        self.norm = make_norm(norm_cls, hidden_size)
        self.proj = Dense(hidden_size, out_dim, zero_init=True)

    def forward(self, x, vec):
        shift, scale = self.mod(F.silu(vec)).chunk(2, dim=-1)
        return self.proj(modulate(apply_norm(self.norm, x), shift, scale))
