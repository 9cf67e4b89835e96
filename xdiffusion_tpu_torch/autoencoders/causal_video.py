"""Causal 3-D video VAEs on one shared plan-driven implementation.

Counterpart of xdiffusion_tpu/autoencoders/causal_video.py: convolutions
causal in time (left padding that repeats the first frame, and `ceil`
padding for strided time, so T -> ceil(T / stride)), zero padding in space,
GroupNorm (eps 1e-5, K3) or pixel norm, each followed by a SiLU, residual blocks, nearest-neighbour
upsampling, and gaussian moments with a uniform or per-channel
log-variance. Two config surfaces: `CausalVideoAutoencoder` (the LTX block
vocabulary) and `HunyuanCausal3DVAE` (block_out_channels and compression
ratios); the shipped configs name ltx_vae.py's and hunyuan.py's classes
instead. Video layout (B, F, H, W, C).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.autoencoders.base import VariationalAutoEncoder
from xdiffusion_tpu_torch.autoencoders.distributions import (  # noqa: F401 (the JAX name)
    moments_to_distribution as _moments_to_distribution,
)
from xdiffusion_tpu_torch.layers.linear import Conv
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for


def pad_frames(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """(B, F, ...) with the first frame repeated `before` times ahead and the
    last `after` times behind (jnp.pad mode "edge" on the frame axis)."""
    parts = [x[:, :1]] * before + [x] + [x[:, -1:]] * after
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


class CausalConv3d(nn.Module):
    """3-D conv, causal on the frame axis (left pad only, plus the `ceil` pad
    of a strided time axis), zero 'SAME'-width padding in space."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), strides=(1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        self.kt, self.st = kt, strides[0]
        self.conv = Conv(in_channels, features, kernel, strides,
                         padding=((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(pad_frames(x, self.kt - 1, (-x.shape[1]) % self.st))


class PixelNormSiLU(nn.Module):
    """silu(x / rms(x)) over the channels, eps 1e-6 (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6))


def _norm_module(kind: str, channels: int) -> nn.Module:
    """The norm and the SiLU after it: GroupNorm (K3, eps 1e-5) with the SiLU
    fused, its scale and bias at the norm's own name as in the flax tree, or
    the pixel norm."""
    if kind == "pixel_norm":
        return PixelNormSiLU()
    return FastGroupNorm(channels, num_groups_for(channels), silu=True)


class CausalResBlock3D(nn.Module):
    def __init__(self, in_channels: int, features: int, norm_layer: str = "group_norm",
                 spatial_only: bool = False):
        super().__init__()
        kernel = (1, 3, 3) if spatial_only else (3, 3, 3)
        self.norm1 = _norm_module(norm_layer, in_channels)
        self.conv1 = CausalConv3d(in_channels, features, kernel)
        self.norm2 = _norm_module(norm_layer, features)
        self.conv2 = CausalConv3d(features, features, kernel)
        self.skip = Conv(in_channels, features, (1, 1, 1)) if in_channels != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.skip is None else self.skip(x)) + h


class CausalUpsample(nn.Module):
    """2x nearest upsampling in space (and time), then a causal conv."""

    def __init__(self, in_channels: int, features: int, temporal: bool = True):
        super().__init__()
        self.temporal = temporal
        self.conv = CausalConv3d(in_channels, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if self.temporal:
            x = x.repeat_interleave(2, dim=1)
        return self.conv(x)


_STRIDES = {"compress_all": ((3, 3, 3), (2, 2, 2)), "compress_space": ((1, 3, 3), (1, 2, 2)),
            "compress_time": ((3, 1, 1), (2, 1, 1))}


class _CausalVAEModule(nn.Module):
    """Encoder and decoder from plans of (op, features) stages."""

    def __init__(self, encoder_plan, decoder_plan, latent_channels: int, in_channels: int,
                 out_channels: int, base_features: int, norm_layer: str = "group_norm",
                 latent_log_var: str = "uniform"):
        super().__init__()
        self.enc_names = self._stages("enc", encoder_plan, base_features, norm_layer)
        c = encoder_plan[-1][1] if encoder_plan else base_features
        self.conv_in = CausalConv3d(in_channels, base_features)
        self.enc_norm_out = _norm_module(norm_layer, c)
        var_ch = 1 if latent_log_var == "uniform" else latent_channels
        self.enc_out = CausalConv3d(c, latent_channels + var_ch)
        self.dec_in = CausalConv3d(latent_channels, decoder_plan[0][1])
        self.dec_names = self._stages("dec", decoder_plan, decoder_plan[0][1], norm_layer)
        c = decoder_plan[-1][1]
        self.dec_norm_out = _norm_module(norm_layer, c)
        self.dec_out = CausalConv3d(c, out_channels)

    def _stages(self, prefix: str, plan, c: int, norm_layer: str) -> List[str]:
        names = []
        for i, (op, feat) in enumerate(plan):
            name = f"{prefix}_{i}_{op}"
            if op in ("res_x", "res_x_y"):
                mod = CausalResBlock3D(c, feat, norm_layer, spatial_only=op == "res_x_y")
            elif op in _STRIDES:
                mod = CausalConv3d(c, feat, *_STRIDES[op])
            elif op in ("upsample_all", "upsample_space"):
                mod = CausalUpsample(c, feat, temporal=op == "upsample_all")
            else:
                raise NotImplementedError(op)
            self.add_module(name, mod)
            names.append(name)
            c = feat
        return names

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for name in self.enc_names:
            h = getattr(self, name)(h)
        return self.enc_out(self.enc_norm_out(h))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_in(z)
        for name in self.dec_names:
            h = getattr(self, name)(h)
        return self.dec_out(self.dec_norm_out(h))


class _CausalVAEBase(VariationalAutoEncoder):
    last_layer_marker = "dec_out"

    def __init__(self, config, device, module: _CausalVAEModule, latent_channels: int):
        super().__init__(config, device)
        self.latent_channels = latent_channels
        self.ae = module
        self._build_loss()
        self._place()


class CausalVideoAutoencoder(_CausalVAEBase):
    """The LTX block vocabulary: features start at 64 and double (at most
    512) at each compression; the decoder mirrors them with upsampling."""

    def __init__(self, config, device=None, **kwargs):
        enc_plan, dec_plan, feat = [], [], 64
        for op, count in config.encoder_blocks:
            for _ in range(int(count)):
                if op.startswith("compress"):
                    feat = min(feat * 2, 512)
                enc_plan.append((op, feat))
        dec_feat = feat
        for op, count in config.decoder_blocks:
            for _ in range(int(count)):
                if op.startswith("compress"):
                    dec_feat = max(dec_feat // 2, 64)
                    op = "upsample_all" if op == "compress_all" else "upsample_space"
                dec_plan.append((op, dec_feat))
        module = _CausalVAEModule(
            tuple(enc_plan), tuple(dec_plan), int(config.latent_channels),
            int(config.in_channels), int(config.out_channels), 64,
            config.get("norm_layer", "group_norm"), config.get("latent_log_var", "uniform"))
        super().__init__(config, device, module, int(config.latent_channels))


class HunyuanCausal3DVAE(_CausalVAEBase):
    """The HunyuanVideo surface on the shared plan: res_x stages per level,
    spatial compression at the first log2(spatial ratio) transitions, the
    last log2(time ratio) of those in time too."""

    def __init__(self, config, device=None, **kwargs):
        chans = list(config.block_out_channels)
        layers = int(config.get("layers_per_block", 2))
        t_downs = int(math.log2(int(config.get("time_compression_ratio", 4))))
        s_downs = int(math.log2(int(config.get("spatial_compression_ratio", 8))))
        enc_plan: List[Tuple[str, int]] = []
        for level, feat in enumerate(chans):
            enc_plan += [("res_x", feat)] * layers
            if level < len(chans) - 1 and level < s_downs:
                op = "compress_all" if level >= s_downs - t_downs else "compress_space"
                enc_plan.append((op, chans[level + 1]))
        rev = list(reversed(chans))
        dec_plan: List[Tuple[str, int]] = []
        for level, feat in enumerate(rev):
            dec_plan += [("res_x", feat)] * layers
            rev_level = len(chans) - 2 - level
            if 0 <= rev_level < s_downs:
                op = "upsample_all" if rev_level >= s_downs - t_downs else "upsample_space"
                dec_plan.append((op, rev[level + 1]))
        module = _CausalVAEModule(
            tuple(enc_plan), tuple(dec_plan), int(config.latent_channels),
            int(config.in_channels), int(config.out_channels), chans[0], "group_norm",
            config.get("latent_logvar", "per_channel"))
        super().__init__(config, device, module, int(config.latent_channels))
