"""LDM-style VAE encoder and decoder, NHWC.

Counterpart of xdiffusion_tpu/autoencoders/layers.py: timestep-free residual
blocks whose GroupNorm (eps 1e-6, 32 groups or c/4) and SiLU run as K3
(layers.resnet.FastGroupNorm), their convolutions as F.conv2d (the JAX
package's plain nn.Conv: no K4), and single-head self-attention over all
h*w tokens of width C, which `attention_qkv` sends to K1 (K2 in training):
at head dim 256 on the KL VAEs' 256-channel mid blocks, `bsc_plan`'s wide
variant. The mid block always has that attention; the levels have it at
`attn_resolutions`. Its output projection starts at zero, as in JAX.
Dropout is not ported: no shipped config sets it, and a positive rate
raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.layers.linear import Conv, Dense
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, nearest_upsample_2x, num_groups_for
from xdiffusion_tpu_torch.ops.attention import attention_qkv


def _gn(c: int, silu: bool = False) -> FastGroupNorm:
    return FastGroupNorm(c, num_groups_for(c), epsilon=1e-6, silu=silu)


def _no_dropout(dropout: float) -> None:
    if dropout > 0.0:
        raise NotImplementedError("VAE dropout is not ported: no shipped config sets it")


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0):
        super().__init__()
        _no_dropout(dropout)
        self.norm1 = _gn(in_channels, silu=True)
        self.conv1 = Conv(in_channels, out_channels, (3, 3))
        self.norm2 = _gn(out_channels, silu=True)
        self.conv2 = Conv(out_channels, out_channels, (3, 3))
        self.skip = Conv(in_channels, out_channels, (1, 1)) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.skip is None else self.skip(x)) + h


class VAEAttnBlock(nn.Module):
    """One head of width C over all h*w tokens (LDM's AttnBlock): q, k, v
    and proj Dense over the channels, scale C**-0.5, K1."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _gn(channels)
        self.q, self.k, self.v = (Dense(channels, channels) for _ in range(3))
        self.proj = Dense(channels, channels, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        n = self.norm(x).reshape(b, h * w, c)
        out = attention_qkv(self.q(n), self.k(n), self.v(n), heads=1)
        return x + self.proj(out).reshape(b, h, w, c)


def _attn_res(resolution) -> int:
    """The resolution that gates attn_resolutions: a rectangular input's
    smaller side."""
    if isinstance(resolution, (list, tuple)):
        return min(int(r) for r in resolution)
    return int(resolution)


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, z_channels: int,
                 attn_resolutions: Sequence[int] = (), resolution=32, dropout: float = 0.0,
                 double_z: bool = True, in_channels: int = 3):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.conv_in = Conv(in_channels, ch, (3, 3))
        self.plan = []  # (module name, kind) in call order
        res, c = _attn_res(resolution), ch
        for level, mult in enumerate(self.ch_mult):
            for i in range(num_res_blocks):
                self._add(f"down_{level}_block_{i}", VAEResnetBlock(c, ch * mult, dropout))
                c = ch * mult
                if res in attn_resolutions:
                    self._add(f"down_{level}_attn_{i}", VAEAttnBlock(c))
            if level != len(self.ch_mult) - 1:
                self._add(f"down_{level}_downsample", Conv(c, c, (3, 3), 2))
                res //= 2
        self._add("mid_block_1", VAEResnetBlock(c, c, dropout))
        self._add("mid_attn", VAEAttnBlock(c))
        self._add("mid_block_2", VAEResnetBlock(c, c, dropout))
        self.norm_out = _gn(c, silu=True)
        self.conv_out = Conv(c, 2 * z_channels if double_z else z_channels, (3, 3))

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.plan.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.plan:
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, z_channels: int,
                 out_ch: int = 3, attn_resolutions: Sequence[int] = (), resolution=32,
                 dropout: float = 0.0):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, c, (3, 3))
        self.plan = []
        for name, mod in (("mid_block_1", VAEResnetBlock(c, c, dropout)),
                          ("mid_attn", VAEAttnBlock(c)),
                          ("mid_block_2", VAEResnetBlock(c, c, dropout))):
            self._add(name, mod)
        res = _attn_res(resolution) // 2 ** (len(ch_mult) - 1)
        for level, mult in reversed(list(enumerate(ch_mult))):
            for i in range(num_res_blocks + 1):
                self._add(f"up_{level}_block_{i}", VAEResnetBlock(c, ch * mult, dropout))
                c = ch * mult
                if res in attn_resolutions:
                    self._add(f"up_{level}_attn_{i}", VAEAttnBlock(c))
            if level != 0:
                self._add(f"up_{level}_upsample", Conv(c, c, (3, 3)))
                res *= 2
        self.norm_out = _gn(c, silu=True)
        self.conv_out = Conv(c, out_ch, (3, 3))

    _add = Encoder._add

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        for name in self.plan:
            if name.endswith("_upsample"):
                h = nearest_upsample_2x(h)
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h))
