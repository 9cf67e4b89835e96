"""LTX-Video transformer (video DiT over a (F, H, W, C) token grid).

Counterpart of xdiffusion_tpu/score_networks/ltx_video.py (LTX-Video,
arXiv:2501.00103). Tokens are the flattened grid; every block runs
self-attention, caption cross-attention and a feed-forward, with adaLN-single
modulation (one shared timestep MLP and a scale_shift_table per block):

- fractional-position, exp-spaced RoPE: positions normalised by
  positional_embedding_max_pos, frequencies theta ** linspace(0, 1, dim // 6)
  * pi / 2 applied to (2 * frac - 1), laid out frequency-major over the three
  axes, cos/sin pair-doubled over the full inner dim (front-padded with the
  identity when dim % 6 != 0), applied to q and k before the head split;
- affine-free RMS standardisation (eps 1e-6) and learned qk RMSNorm over the
  full inner dim (eps 1e-5) in both attentions;
- cross-attention reads the raw residual stream;
- skip-layer guidance: context["skip_layer_mask"] (num_layers, B) blends
  each block's self-attention output with its input.

Attention without a text mask goes to `ops.attention.dot_product_attention`
(K5 on CUDA tensors); with `text_attention_mask` the cross-attention is an
einsum with a -10000 bias, as in the JAX package. The module tree mirrors
the flax parameter paths (`block_{i}/qkv/kernel` -> `block_{i}.qkv.weight`).

The network computes in its parameters' dtype: the input, the text
embeddings, the fp32 sinusoidal timestep features and the fp32 RoPE tables
are cast to it, so a bf16 network runs in bf16 throughout (a flax module
with bf16 parameters promotes back to fp32 from those fp32 features). In
fp32 the two agree. The output is fp32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import RMSNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention


def _rms_no_affine(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rrms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rrms).to(x.dtype)


def _linspace01(n: int) -> torch.Tensor:
    """jnp.linspace(0, 1, n) in fp32, bit for bit as XLA computes it: iota
    times the fp32 reciprocal of n - 1, then 1. The frequencies reach
    theta * pi / 2, so an ulp here moves the RoPE tables by 1e-3."""
    if n == 1:
        return torch.zeros(1)
    div = n - 1
    step = torch.ones((), dtype=torch.float32) / div
    return torch.cat([torch.arange(div, dtype=torch.float32) * step, torch.ones(1)])


def ltx_rope_frequencies(ids: torch.Tensor, dim: int, max_pos: Sequence[int],
                         theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables (N, dim) of the LTX fractional exp-spaced RoPE
    for raw (frame, row, col) indices `ids` (N, 3)."""
    n6 = dim // 6
    frac = ids.float() / torch.tensor(list(max_pos), dtype=torch.float32, device=ids.device)
    indices = theta ** _linspace01(n6).to(ids.device)
    indices = indices * (math.pi / 2.0)
    # (N, 3, n6) -> (N, n6, 3) -> (N, 3 * n6): frequency-major over the axes.
    freqs = indices[None, None, :] * (frac[:, :, None] * 2.0 - 1.0)
    freqs = freqs.transpose(1, 2).reshape(ids.shape[0], 3 * n6)
    cos = torch.repeat_interleave(torch.cos(freqs), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(freqs), 2, dim=-1)
    pad = dim % 6
    if pad:
        cos = torch.cat([torch.ones_like(cos[:, :pad]), cos], dim=-1)
        sin = torch.cat([torch.zeros_like(sin[:, :pad]), sin], dim=-1)
    return cos, sin


def _apply_ltx_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotates (B, N, D) by interleaved-pair tables (N, D)."""
    b, n, d = t.shape
    x = t.reshape(b, n, d // 2, 2)
    rot = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(b, n, d)
    return t * cos[None] + rot * sin[None]


class LTXBlock(nn.Module):
    """One transformer block with adaptive single scale-shift modulation and
    RMS standardisation. Dense layers compute in their inputs' and
    parameters' dtype."""

    def __init__(self, dim: int, num_heads: int, norm_eps: float = 1e-6):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm_eps = norm_eps
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / dim ** 0.5)
        self.qkv = Dense(dim, 3 * dim, dtype=None)
        self.q_norm = RMSNorm(dim, eps=1e-5)
        self.k_norm = RMSNorm(dim, eps=1e-5)
        self.attn_proj = Dense(dim, dim, dtype=None)
        self.cross_q = Dense(dim, dim, dtype=None)
        self.cross_kv = Dense(dim, 2 * dim, dtype=None)
        self.cross_q_norm = RMSNorm(dim, eps=1e-5)
        self.cross_k_norm = RMSNorm(dim, eps=1e-5)
        self.cross_proj = Dense(dim, dim, dtype=None)
        self.ff1 = Dense(dim, 4 * dim, dtype=None)
        self.ff2 = Dense(4 * dim, dim, dtype=None)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """(B, L, H*D) -> the (B, H, L, D) view."""
        b, l, _ = t.shape
        return t.reshape(b, l, self.num_heads, -1).transpose(1, 2)

    @staticmethod
    def _merge(t: torch.Tensor) -> torch.Tensor:
        b, h, l, d = t.shape
        return t.transpose(1, 2).reshape(b, l, h * d)

    def forward(self, x, y, shared_mod, cos, sin, text_mask: Optional[torch.Tensor] = None,
                skip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        mod = shared_mod + self.scale_shift_table[None]
        s1, sc1, g1, s2, sc2, g2 = mod.unbind(1)

        h = _rms_no_affine(x, self.norm_eps)
        h = h * (1 + sc1[:, None]) + s1[:, None]
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        # Learned RMS qk-norm over the full inner dim, then RoPE, then heads.
        q = _apply_ltx_rope(self.q_norm(q), cos, sin)
        k = _apply_ltx_rope(self.k_norm(k), cos, sin)
        attn = self._merge(dot_product_attention(self._heads(q), self._heads(k),
                                                 self._heads(v)))
        if skip_mask is not None:
            # Skip-layer strategy "attention": per sample, the block's
            # (normed, modulated) input replaces the attention output.
            m = skip_mask[:, None, None].to(attn.dtype)
            attn = attn * m + h * (1.0 - m)
        x = x + g1[:, None] * self.attn_proj(attn)

        # Caption cross-attention on the raw residual stream.
        cq = self.cross_q_norm(self.cross_q(x))
        ck, cv = self.cross_kv(y).chunk(2, dim=-1)
        ck = self.cross_k_norm(ck)
        if text_mask is not None:
            hd = self.dim // self.num_heads
            logits = torch.einsum("bhqd,bhkd->bhqk", self._heads(cq).float(),
                                  self._heads(ck).float()) * hd ** -0.5
            bias = torch.where(text_mask[:, None, None, :].bool(), 0.0, -10000.0)
            w = torch.softmax(logits + bias, dim=-1)
            cross = torch.einsum("bhqk,bhkd->bhqd", w.to(cv.dtype), self._heads(cv))
        else:
            cross = dot_product_attention(self._heads(cq), self._heads(ck), self._heads(cv))
        x = x + self.cross_proj(self._merge(cross))

        h = _rms_no_affine(x, self.norm_eps)
        h = h * (1 + sc2[:, None]) + s2[:, None]
        h = self.ff2(F.gelu(self.ff1(h), approximate="tanh"))
        return x + g2[:, None] * h


class LTXVideoTransformer(nn.Module):
    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        d = int(cfg.attention_head_dim) * int(cfg.num_attention_heads)
        self.dim = d
        self.num_heads = int(cfg.num_attention_heads)
        self.num_layers = int(cfg.num_layers)
        self.is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        self.out_channels = int(cfg.out_channels) * (2 if self.is_learned_sigma else 1)
        self.max_pos = tuple(cfg.get("positional_embedding_max_pos", [20, 2048, 2048]))
        self.rope_theta = float(cfg.get("positional_embedding_theta", 10000.0))
        self.t_scale = float(cfg.get("timestep_scale_multiplier", 1000))
        caption_channels = int(cfg.get("caption_channels", cfg.get("cross_attention_dim", d)))
        if not cfg.get("attention_bias", True):
            raise NotImplementedError("LTX attention without biases is not ported yet")
        if cfg.get("standardization_norm", "rms_norm") != "rms_norm":
            raise NotImplementedError("LTX LayerNorm standardisation is not ported yet")

        self.proj_in = Dense(int(cfg.input_channels), d, dtype=None)
        # Text projection: linear -> tanh-GELU -> linear.
        self.caption_fc1 = Dense(caption_channels, d, dtype=None)
        self.caption_fc2 = Dense(d, d, dtype=None)
        self.t_block = Dense(d, 6 * d, dtype=None)
        self.t_fc1 = Dense(256, d, dtype=None)
        self.t_fc2 = Dense(d, d, dtype=None)
        for i in range(self.num_layers):
            self.add_module(f"block_{i}", LTXBlock(d, self.num_heads,
                                                   norm_eps=float(cfg.get("norm_eps", 1e-6))))
        self.scale_shift_table = nn.Parameter(torch.randn(2, d) / d ** 0.5)
        self.proj_out = Dense(d, self.out_channels, dtype=None, zero_init=True)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C). Returns (B, F, H, W, out_channels) fp32 (a pair
        of halves when the sigma is learned)."""
        dt = self.proj_in.weight.dtype
        dev = x.device
        b, f, h, w, c = x.shape
        tokens = self.proj_in(x.to(dt).reshape(b, f * h * w, c))

        # Raw (frame, row, col) indices, fractionalised inside the RoPE.
        fi = torch.arange(f, device=dev).repeat_interleave(h * w)
        ri = torch.arange(h, device=dev).repeat_interleave(w).repeat(f)
        ci = torch.arange(w, device=dev).repeat(f * h)
        cos, sin = ltx_rope_frequencies(torch.stack([fi, ri, ci], dim=-1), self.dim,
                                        self.max_pos, self.rope_theta)
        cos, sin = cos.to(dt), sin.to(dt)

        timestep = context["timestep"].float() * self.t_scale
        temb = self.t_fc2(F.silu(self.t_fc1(glide_timestep_embedding(timestep, 256).to(dt))))
        shared_mod = self.t_block(F.silu(temb)).reshape(b, 6, self.dim)
        y = context["text_embeddings"]
        if y.ndim == 4:  # (B, 1, L, C)
            y = y[:, 0]
        y = self.caption_fc2(F.gelu(self.caption_fc1(y.to(device=dev, dtype=dt)),
                                    approximate="tanh"))
        text_mask = context.get("text_attention_mask")
        if text_mask is not None and text_mask.ndim > 2:
            text_mask = text_mask.reshape(b, -1)
        skip_layer_mask = context.get("skip_layer_mask")

        for i in range(self.num_layers):
            tokens = getattr(self, f"block_{i}")(
                tokens, y, shared_mod, cos, sin, text_mask=text_mask,
                skip_mask=None if skip_layer_mask is None else skip_layer_mask[i])

        final_mod = self.scale_shift_table[None] + temb[:, None]  # (B, 2, D)
        shift, scale = final_mod[:, 0], final_mod[:, 1]
        tokens = F.layer_norm(tokens.float(), (self.dim,), eps=1e-6).to(tokens.dtype)
        tokens = tokens * (1 + scale[:, None]) + shift[:, None]
        out = self.proj_out(tokens).reshape(b, f, h, w, self.out_channels).float()
        if self.is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
