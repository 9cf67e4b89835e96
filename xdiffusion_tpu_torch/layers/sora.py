"""PixArt-Sigma's key/value compression for the Sora layer library.

Counterpart of `KVCompressAttention` in xdiffusion_tpu/layers/sora.py:
self-attention over (B, N, C) tokens of an (H, W) grid whose keys and
values are downsampled by `sr_ratio` before the product, by a depthwise
sr x sr convolution of stride sr (initially an average) and a LayerNorm,
both shared by k and v (`sampling: conv`), a strided pick on the grid
(`uniform`, `ave`), or every sr-th token of the sequence
(`uniform_every`). Like the JAX layer it computes plain einsums, logits
and softmax in fp32, with an optional additive mask (-inf where mask <= 0).
No shipped config reaches it.

The depthwise kernel keeps the flax layout and name, `sr_kernel` (sr, sr,
1, C), so the weight bridge carries it as it is; `sr_bias` and `sr_norm`
likewise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm, RMSNorm


class KVCompressAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_norm: bool = False, sampling: str = "conv", sr_ratio: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sampling not in ("conv", "uniform", "ave", "uniform_every"):
            raise ValueError(f"unknown sampling {sampling}")
        self.dim = dim
        self.num_heads = num_heads
        self.sampling = sampling
        self.sr_ratio = int(sr_ratio)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, bias=qkv_bias)
        self.proj = Dense(dim, dim, dtype=dtype)
        s = self.sr_ratio
        if s > 1 and sampling == "conv":
            self.sr_kernel = nn.Parameter(torch.full((s, s, 1, dim), 1.0 / (s * s)))
            self.sr_bias = nn.Parameter(torch.zeros(dim))
            self.sr_norm = LayerNorm(dim)
        hd = dim // num_heads
        self.q_norm = RMSNorm(hd) if qk_norm else None
        self.k_norm = RMSNorm(hd) if qk_norm else None

    def _downsample(self, t: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        s = self.sr_ratio
        if s == 1:
            return t
        b, n, c = t.shape
        if self.sampling == "uniform_every":
            return t[:, ::s]
        h, w = hw
        grid = t.reshape(b, h, w, c)
        if self.sampling in ("uniform", "ave"):
            return grid[:, ::s, ::s].reshape(b, (h // s) * (w // s), c)
        # conv: depthwise sr x sr, stride sr, VALID, then the LayerNorm.
        weight = self.sr_kernel.permute(3, 2, 0, 1)  # HWIO (s, s, 1, C) -> (C, 1, s, s)
        out = F.conv2d(grid.permute(0, 3, 1, 2), weight.to(t.dtype), stride=s, groups=c)
        out = out.permute(0, 2, 3, 1) + self.sr_bias.to(t.dtype)
        return self.sr_norm(out.reshape(b, -1, c))

    def forward(self, x: torch.Tensor, hw: Optional[Tuple[int, int]] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        if c != self.dim:
            raise ValueError(f"width {c} against the layer's {self.dim}")
        hd = c // self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        if self.sr_ratio > 1:
            if hw is None:
                raise ValueError("KV compression needs the (H, W) grid")
            k, v = self._downsample(k, hw), self._downsample(v, hw)

        def split(t):
            return t.reshape(b, t.shape[1], self.num_heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
        if mask is not None:
            logits = logits + torch.where(mask > 0, 0.0, float("-inf"))
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))
