"""HunyuanVideo causal 3-D VAE.

Counterpart of xdiffusion_tpu/autoencoders/hunyuan.py: causal 3-D
convolutions that repeat the edge pixels (k - 1 frames ahead in time, k // 2
on each side in space), Down/Up blocks of residual blocks (spatial strides on
the first log2(spatial ratio) levels, temporal strides on the last
log2(time ratio) non-final ones), a mid block with frame-causal full
attention, first-frame-aware nearest upsampling, 1x1x1 quant and post-quant
convs, and spatially and temporally tiled encode and decode with blended
overlaps. Layout NDHWC.

The GroupNorms (32 groups on 32, 64 and 128 channels: 1, 2 and 4 channels
a group, eps 1e-6, statistics over all frames) run as K3 on the whole (B,
F*H*W, C) map. The mid block's attention stays plain einsums with the
block-causal frame mask, as JAX computes it: no kernel of the port takes a
mask. Dropout is not ported (no shipped config sets it).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.autoencoders.base import VariationalAutoEncoder
from xdiffusion_tpu_torch.autoencoders.causal_video import pad_frames
from xdiffusion_tpu_torch.layers.linear import Conv, Dense
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for


def _edge_pad(x: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """(B, F, H, W, C) padded by repeating edges: t frames ahead, s pixels
    on each side of H and W."""
    if s:
        x = F.pad(x.movedim(-1, 1), (s, s, s, s, 0, 0), mode="replicate").movedim(1, -1)
    return pad_frames(x, t, 0)


class CausalConv3d(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, strides=(1, 1, 1)):
        super().__init__()
        self.k = kernel_size
        self.conv = Conv(in_channels, features, (kernel_size,) * 3, strides, padding="VALID")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.k > 1:
            x = _edge_pad(x, self.k - 1, self.k // 2)
        return self.conv(x)


def _group_norm(c: int, silu: bool = False) -> FastGroupNorm:
    return FastGroupNorm(c, num_groups_for(c), epsilon=1e-6, silu=silu)


class ResnetBlockCausal3D(nn.Module):
    def __init__(self, in_channels: int, features: int, dropout: float = 0.0):
        super().__init__()
        if dropout > 0.0:
            raise NotImplementedError("hunyuan: dropout is not ported")
        self.norm1 = _group_norm(in_channels, silu=True)
        self.conv1 = CausalConv3d(in_channels, features)
        self.norm2 = _group_norm(features, silu=True)
        self.conv2 = CausalConv3d(features, features)
        self.conv_shortcut = (CausalConv3d(in_channels, features, 1)
                              if in_channels != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class UpsampleCausal3D(nn.Module):
    """Nearest upsampling, the first frame in space only, then a causal conv."""

    def __init__(self, in_channels: int, features: int, upsample_factor=(2, 2, 2)):
        super().__init__()
        self.factor = tuple(upsample_factor)
        self.conv = CausalConv3d(in_channels, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ft, fh, fw = self.factor
        x = x.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
        if ft > 1 and x.shape[1] > 1:
            x = torch.cat([x[:, :1], x[:, 1:].repeat_interleave(ft, dim=1)], dim=1)
        return self.conv(x)


class _CausalAttention(nn.Module):
    """Attention over all F*H*W tokens, a token of frame i seeing frames <= i;
    GroupNorm (K3) first, plain einsums with fp32 logits."""

    def __init__(self, channels: int, head_dim: int):
        super().__init__()
        self.heads = max(1, channels // head_dim)
        self.group_norm = _group_norm(channels)
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(channels, channels)
                                                        for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        hd = c // self.heads
        tokens = self.group_norm(x).reshape(b, f * h * w, c)

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.to_q(tokens)), split(self.to_k(tokens)), split(self.to_v(tokens))
        fi = torch.arange(f, device=x.device).repeat_interleave(h * w)
        mask = torch.where(fi[:, None] >= fi[None, :], 0.0, float("-inf"))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
        weights = torch.softmax(logits + mask, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v).transpose(1, 2)
        return x + self.to_out(out.reshape(b, f * h * w, c)).reshape(b, f, h, w, c)


class UNetMidBlockCausal3D(nn.Module):
    def __init__(self, features: int, add_attention: bool = True, attention_head_dim=None,
                 num_layers: int = 1):
        super().__init__()
        self.num_layers, self.add_attention = num_layers, add_attention
        self.res_0 = ResnetBlockCausal3D(features, features)
        for i in range(num_layers):
            if add_attention:
                self.add_module(f"attn_{i}",
                                _CausalAttention(features, attention_head_dim or features))
            self.add_module(f"res_{i + 1}", ResnetBlockCausal3D(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res_0(x)
        for i in range(self.num_layers):
            if self.add_attention:
                x = getattr(self, f"attn_{i}")(x)
            x = getattr(self, f"res_{i + 1}")(x)
        return x


def _down_up_plan(n_levels: int, spatial_ratio: int, time_ratio: int) -> List[Tuple[bool, bool]]:
    """(spatial stride, temporal stride) per level."""
    n_s, n_t = int(math.log2(spatial_ratio)), int(math.log2(time_ratio))
    return [(i < n_s, i >= n_levels - 1 - n_t and i != n_levels - 1) for i in range(n_levels)]


class EncoderCausal3D(nn.Module):
    def __init__(self, in_channels: int, latent_channels: int, block_out_channels,
                 layers_per_block: int = 2, time_compression_ratio: int = 4,
                 spatial_compression_ratio: int = 8, mid_block_add_attention: bool = True,
                 latent_logvar: str = "uniform"):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = CausalConv3d(in_channels, chans[0])
        self.names = []
        c = chans[0]
        for i, (add_s, add_t) in enumerate(_down_up_plan(len(chans), spatial_compression_ratio,
                                                         time_compression_ratio)):
            for j in range(layers_per_block):
                self._add(f"down_{i}_res_{j}", ResnetBlockCausal3D(c, chans[i]))
                c = chans[i]
            if add_s or add_t:
                stride = (2 if add_t else 1, 2 if add_s else 1, 2 if add_s else 1)
                self._add(f"down_{i}_downsample", CausalConv3d(c, c, 3, stride))
        self.mid_block = UNetMidBlockCausal3D(c, mid_block_add_attention, c)
        self.conv_norm_out = _group_norm(c, silu=True)
        conv_out = {"per_channel": 2 * latent_channels, "uniform": latent_channels + 1,
                    "none": latent_channels}
        if latent_logvar not in conv_out:
            raise ValueError(f"invalid latent_logvar {latent_logvar}")
        self.conv_out = CausalConv3d(c, conv_out[latent_logvar])

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.names.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class DecoderCausal3D(nn.Module):
    def __init__(self, latent_channels: int, out_channels: int, block_out_channels,
                 layers_per_block: int = 2, time_compression_ratio: int = 4,
                 spatial_compression_ratio: int = 8, mid_block_add_attention: bool = True):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = CausalConv3d(latent_channels, rev[0])
        self.mid_block = UNetMidBlockCausal3D(rev[0], mid_block_add_attention, rev[0])
        self.names = []
        c = rev[0]
        for i, (add_s, add_t) in enumerate(_down_up_plan(len(rev), spatial_compression_ratio,
                                                         time_compression_ratio)):
            for j in range(layers_per_block + 1):
                self._add(f"up_{i}_res_{j}", ResnetBlockCausal3D(c, rev[i]))
                c = rev[i]
            if add_s or add_t:
                factor = (2 if add_t else 1, 2 if add_s else 1, 2 if add_s else 1)
                self._add(f"up_{i}_upsample", UpsampleCausal3D(c, c, factor))
        self.conv_norm_out = _group_norm(c, silu=True)
        self.conv_out = CausalConv3d(c, out_channels)

    _add = EncoderCausal3D._add

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(self.conv_norm_out(x))


class _HunyuanVAEModule(nn.Module):
    def __init__(self, config, latent_channels: int):
        super().__init__()
        self.latent_channels = latent_channels
        self.latent_logvar = config.get("latent_logvar", "uniform")
        common = dict(block_out_channels=tuple(config.block_out_channels),
                      layers_per_block=int(config.get("layers_per_block", 2)),
                      time_compression_ratio=int(config.get("time_compression_ratio", 4)),
                      spatial_compression_ratio=int(config.get("spatial_compression_ratio", 8)),
                      mid_block_add_attention=bool(config.get("mid_block_add_attention", True)))
        self.encoder = EncoderCausal3D(int(config.in_channels), latent_channels,
                                       latent_logvar=self.latent_logvar, **common)
        self.decoder = DecoderCausal3D(latent_channels, int(config.out_channels), **common)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, (1, 1, 1))
        self.post_quant_conv = Conv(latent_channels, latent_channels, (1, 1, 1))

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x)
        if self.latent_logvar == "uniform":
            mean, logvar = h[..., :self.latent_channels], h[..., -1:]
            h = torch.cat([mean, logvar.expand(mean.shape)], dim=-1)
        elif self.latent_logvar == "none":
            h = torch.cat([h, torch.zeros_like(h)], dim=-1)
        return self.quant_conv(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def _blend(a: torch.Tensor, b: torch.Tensor, axis: int, extent: int) -> torch.Tensor:
    """b with its first `extent` entries along `axis` lerped from a's last."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent <= 0:
        return b
    shape = [1] * b.ndim
    shape[axis] = extent
    ramp = (torch.arange(extent, dtype=b.dtype, device=b.device) / extent).reshape(shape)
    a_band = a.narrow(axis, a.shape[axis] - extent, extent)
    blended = a_band * (1 - ramp) + b.narrow(axis, 0, extent) * ramp
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)], dim=axis)


class HunyuanCausal3DVAE(VariationalAutoEncoder):
    """The HunyuanVideo VAE on `device` (CUDA unless "cpu"), with optional
    spatial and temporal tiling of encode_to_latents and decode_from_latents
    (`enable_tiling`); training runs untiled, as in JAX."""

    def __init__(self, config, device=None, **kwargs):
        super().__init__(config, device)
        self.latent_channels = int(config.latent_channels)
        self.ae = _HunyuanVAEModule(config, self.latent_channels)
        self._build_loss()
        t_ratio = int(config.get("time_compression_ratio", 4))
        s_levels = len(list(config.block_out_channels)) - 1
        size = config.get("sample_size", 64)
        size = size[0] if isinstance(size, (list, tuple)) else int(size)
        self.t_ratio = t_ratio
        self.tile_sample_min_tsize = int(config.get("sample_tsize", 29))
        self.tile_latent_min_tsize = self.tile_sample_min_tsize // t_ratio
        self.tile_sample_min_size = size
        self.tile_latent_min_size = int(size / (2 ** s_levels))
        self.tile_overlap_factor = 0.25
        self.use_spatial_tiling = False
        self.use_temporal_tiling = False
        self._place()

    def enable_tiling(self, spatial: bool = True, temporal: bool = True) -> None:
        self.use_spatial_tiling, self.use_temporal_tiling = spatial, temporal

    def encode_to_latents(self, x, noise=None, generator=None):
        with torch.no_grad():
            return self.posterior(self._tiled_moments(x)).sample(noise, generator)

    def decode_from_latents(self, z, **kwargs):
        return self._tiled_decode(z)

    def _tiled_moments(self, x):
        if self.use_temporal_tiling and x.shape[1] > self.tile_sample_min_tsize:
            return self._temporal_tiles(x, self.tile_sample_min_tsize,
                                        self.tile_latent_min_tsize, self._spatial_moments,
                                        lambda t: (t - 1) // 4 + 1)
        return self._spatial_moments(x)

    def _tiled_decode(self, z):
        if self.use_temporal_tiling and z.shape[1] > self.tile_latent_min_tsize:
            return self._temporal_tiles(z, self.tile_latent_min_tsize,
                                        self.tile_sample_min_tsize, self._spatial_decode,
                                        lambda t: (t - 1) * self.t_ratio + 1)
        return self._spatial_decode(z)

    def _spatial_moments(self, x):
        if self.use_spatial_tiling and max(x.shape[2], x.shape[3]) > self.tile_sample_min_size:
            return self._spatial_tiles(x, self.tile_sample_min_size, self.tile_latent_min_size,
                                       self.ae.encode_moments)
        return self.ae.encode_moments(x)

    def _spatial_decode(self, z):
        if self.use_spatial_tiling and max(z.shape[2], z.shape[3]) > self.tile_latent_min_size:
            return self._spatial_tiles(z, self.tile_latent_min_size, self.tile_sample_min_size,
                                       self.ae.decode)
        return self.ae.decode(z)

    def _spatial_tiles(self, x, tile: int, out_tile: int, fn):
        """fn over overlapping tile x tile windows, blended and cut to the
        output's share of each."""
        overlap = int(tile * (1 - self.tile_overlap_factor))
        blend = int(out_tile * self.tile_overlap_factor)
        limit = out_tile - blend
        rows = [[fn(x[:, :, i:i + tile, j:j + tile]) for j in range(0, x.shape[3], overlap)]
                for i in range(0, x.shape[2], overlap)]
        out_rows = []
        for i, row in enumerate(rows):
            merged = []
            for j, t in enumerate(row):
                if i > 0:
                    t = _blend(rows[i - 1][j], t, 2, blend)
                if j > 0:
                    t = _blend(merged[j - 1], t, 3, blend)
                merged.append(t)
            out_rows.append(torch.cat([t[:, :, :, :limit] for t in merged], dim=3))
        return torch.cat([r[:, :, :limit] for r in out_rows], dim=2)

    def _temporal_tiles(self, x, tile: int, out_tile: int, fn, length):
        """fn over windows of tile + 1 frames every tile * 3/4, each later
        window's first output frame dropped, blended, cut to `length(T)`."""
        t = x.shape[1]
        overlap = int(tile * (1 - self.tile_overlap_factor))
        blend = int(out_tile * self.tile_overlap_factor)
        limit = out_tile - blend
        tiles = []
        for i in range(0, t, overlap):
            m = fn(x[:, i:i + tile + 1])
            tiles.append(m[:, 1:] if i > 0 else m)
        merged = [tiles[0][:, :limit + 1]]
        for i in range(1, len(tiles)):
            merged.append(_blend(tiles[i - 1], tiles[i], 1, blend)[:, :limit])
        return torch.cat(merged, dim=1)[:, :length(t)]
