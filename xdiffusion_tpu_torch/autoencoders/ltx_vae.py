"""LTX-Video causal video VAE.

Counterpart of xdiffusion_tpu/autoencoders/ltx_vae.py: the block grammar
(res_x, res_x_y, attn_res_x, compress_time / _space / _all /
_all_x_y) of causal 3-D convolutions (time padded by repeating the edge
frame, causally in the encoder and, unless `causal_decoder`, symmetrically in
the decoder; zero padding in space), DualConv3d (spatial then temporal) for
dims (2, 1), pixel, layer or group norms (GroupNorm through K3), spatial
patchify, DepthToSpaceUpsample decoding (dropping the duplicated first
frame after a temporal stride), the mid block's optional self-attention
(RMS qk-norm, K5 through `dot_product_attention`), the uniform
log-variance broadcast and the optional quant convs. Layout NDHWC.

`CausalVideoAutoencoder` tiles or clips its inputs to
`input_number_of_frames` before it encodes them (`_fit_frames`).

Not ported, and refused with `NotImplementedError` at construction: the
timestep-conditioned (denoising) decoder and StyleGAN-style noise injection
(`timestep_conditioning`, a block's `inject_noise`), and dropout. No shipped
config sets them.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.autoencoders.base import VariationalAutoEncoder
from xdiffusion_tpu_torch.autoencoders.causal_video import pad_frames
from xdiffusion_tpu_torch.layers.linear import Conv, Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm, RMSNorm
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for
from xdiffusion_tpu_torch.ops.attention import dot_product_attention


class CausalConv3d(nn.Module):
    """3-D conv whose time padding repeats the edge frames: (kt - 1, 0) when
    causal, else (kt - 1) // 2 on both sides; zero padding kh // 2, kw // 2
    in space (torch Conv3d's)."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), strides=(1, 1, 1),
                 causal: bool = True, use_bias: bool = True):
        super().__init__()
        kt, kh, kw = kernel
        self.kt, self.causal = kt, causal
        self.conv = Conv(in_channels, features, kernel, strides,
                         padding=((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)), bias=use_bias)

    def forward(self, x: torch.Tensor, causal: Optional[bool] = None) -> torch.Tensor:
        if self.kt > 1:
            is_causal = self.causal if causal is None else causal
            before = self.kt - 1 if is_causal else (self.kt - 1) // 2
            x = pad_frames(x, before, 0 if is_causal else (self.kt - 1) // 2)
        return self.conv(x)


class DualConv3d(nn.Module):
    """Spatial (1, kh, kw) then temporal (kt, 1, 1) conv through an
    intermediate width of max(in, out); zero padding on every axis."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3, 3), strides=(1, 1, 1),
                 padding=(1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        st, sh, sw = strides
        pt, ph, pw = padding
        inter = max(in_channels, features)
        self.conv_spatial = Conv(in_channels, inter, (1, kh, kw), (1, sh, sw),
                                 padding=((0, 0), (ph, ph), (pw, pw)))
        self.conv_temporal = Conv(inter, features, (kt, 1, 1), (st, 1, 1),
                                  padding=((pt, pt), (0, 0), (0, 0)))

    def forward(self, x: torch.Tensor, causal: Optional[bool] = None) -> torch.Tensor:
        return self.conv_temporal(self.conv_spatial(x))


def make_conv_nd(dims, in_channels: int, features: int, kernel_size: int = 3,
                 strides=(1, 1, 1), causal: bool = False, padding: int = 0) -> nn.Module:
    """CausalConv3d for dims 3 (it pads itself; `padding` is ignored), and
    for dims (2, 1) a DualConv3d that honours `padding` (the compress and
    upsample convs pass none and shrink the map, as in the original)."""
    k = (kernel_size,) * 3
    if dims == 3 or dims == (3,):
        return CausalConv3d(in_channels, features, k, strides, causal=causal)
    if isinstance(dims, (list, tuple)) and tuple(dims) == (2, 1):
        return DualConv3d(in_channels, features, k, strides, padding=(padding,) * 3)
    raise ValueError(f"unsupported dims for video VAE: {dims}")


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


class _Norm(nn.Module):
    """group_norm (K3, the SiLU fused), layer_norm or pixel_norm, each
    followed by a SiLU (every use in the network is)."""

    def __init__(self, kind: str, channels: int, eps: float = 1e-6):
        super().__init__()
        self.kind = kind
        if kind == "layer_norm":
            self.ln = LayerNorm(channels, eps=eps)
        elif kind == "group_norm":
            self.gn = FastGroupNorm(channels, num_groups_for(channels), epsilon=eps, silu=True)
        elif kind != "pixel_norm":
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "group_norm":
            return self.gn(x)
        return F.silu(self.ln(x) if self.kind == "layer_norm" else pixel_norm(x, 1e-8))


class ResnetBlock3D(nn.Module):
    """norm / SiLU / causal conv twice; LayerNorm and a 1x1x1 conv on the
    shortcut where the width changes."""

    def __init__(self, dims, in_channels: int, features: int, norm_layer: str = "group_norm",
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = _Norm(norm_layer, in_channels, eps)
        self.conv1 = make_conv_nd(dims, in_channels, features, 3, causal=True, padding=1)
        self.norm2 = _Norm(norm_layer, features, eps)
        self.conv2 = make_conv_nd(dims, features, features, 3, causal=True, padding=1)
        self.reshape = in_channels != features
        if self.reshape:
            self.norm3 = LayerNorm(in_channels, eps=eps)
            self.conv_shortcut = Conv(in_channels, features, (1, 1, 1))

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        h = self.conv1(self.norm1(x), causal=causal)
        h = self.conv2(self.norm2(h), causal=causal)
        if self.reshape:
            x = self.conv_shortcut(self.norm3(x))
        return x + h


class _MidBlockAttention(nn.Module):
    """Self-attention over all F*H*W tokens with RMS qk-norm (eps 1e-5) and a
    residual, K5."""

    def __init__(self, channels: int, head_dim: int):
        super().__init__()
        self.head_dim = head_dim
        self.to_q, self.to_k, self.to_v, self.to_out = (Dense(channels, channels)
                                                        for _ in range(4))
        self.q_norm = RMSNorm(head_dim, eps=1e-5)
        self.k_norm = RMSNorm(head_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        heads = c // self.head_dim
        tokens = x.reshape(b, f * h * w, c)

        def split(t):
            return t.reshape(b, -1, heads, self.head_dim).transpose(1, 2)

        q = self.q_norm(split(self.to_q(tokens)))
        k = self.k_norm(split(self.to_k(tokens)))
        out = dot_product_attention(q.contiguous(), k.contiguous(),
                                    split(self.to_v(tokens)).contiguous())
        out = self.to_out(out.transpose(1, 2).reshape(b, f * h * w, c))
        return (tokens + out).reshape(b, f, h, w, c)


class UNetMidBlock3D(nn.Module):
    """num_layers ResnetBlock3Ds, each followed by attention when
    attention_head_dim > 0."""

    def __init__(self, dims, features: int, num_layers: int = 1, norm_layer: str = "group_norm",
                 attention_head_dim: int = -1):
        super().__init__()
        self.num_layers, self.attention = num_layers, attention_head_dim > 0
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResnetBlock3D(dims, features, features, norm_layer))
            if self.attention:
                self.add_module(f"attn_{i}", _MidBlockAttention(features, attention_head_dim))

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"res_{i}")(x, causal=causal)
            if self.attention:
                x = getattr(self, f"attn_{i}")(x)
        return x


def _unshuffle(t: torch.Tensor, stride) -> torch.Tensor:
    """Pixel unshuffle over (t, h, w) from torch's c-major "(c p1 p2 p3)"
    channel layout."""
    p1, p2, p3 = stride
    b, f, h, w, c = t.shape
    cc = c // (p1 * p2 * p3)
    t = t.reshape(b, f, h, w, cc, p1, p2, p3).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return t.reshape(b, f * p1, h * p2, w * p3, cc)


class DepthToSpaceUpsample(nn.Module):
    """conv -> unshuffle over (t, h, w); drops the duplicated first frame
    after a temporal stride; an optional residual of the tiled input."""

    def __init__(self, dims, in_channels: int, stride=(2, 2, 2), residual: bool = False,
                 out_channels_reduction_factor: int = 1):
        super().__init__()
        self.stride, self.residual = tuple(stride), residual
        self.reps = int(np.prod(stride)) // out_channels_reduction_factor
        self.conv = make_conv_nd(dims, in_channels, self.reps * in_channels, 3, causal=True)

    def forward(self, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
        drop = 1 if self.stride[0] == 2 else 0
        h = _unshuffle(self.conv(x, causal=causal), self.stride)[:, drop:]
        if self.residual:
            h = h + _unshuffle(x.repeat(1, 1, 1, 1, self.reps), self.stride)[:, drop:]
        return h


def patchify(x: torch.Tensor, patch_size_hw: int) -> torch.Tensor:
    """(B, F, H, W, C) -> (B, F, H/q, W/q, C q q), torch's "(c r q)" order."""
    q = patch_size_hw
    if q == 1:
        return x
    b, f, h, w, c = x.shape
    x = x.reshape(b, f, h // q, q, w // q, q, c).permute(0, 1, 2, 4, 6, 5, 3)
    return x.reshape(b, f, h // q, w // q, c * q * q)


def unpatchify(x: torch.Tensor, patch_size_hw: int) -> torch.Tensor:
    q = patch_size_hw
    if q == 1:
        return x
    b, f, h, w, cqq = x.shape
    c = cqq // (q * q)
    x = x.reshape(b, f, h, w, c, q, q).permute(0, 1, 2, 6, 3, 5, 4)
    return x.reshape(b, f, h * q, w * q, c)


def _as_block_params(p) -> Dict:
    if isinstance(p, Mapping):
        return dict(p)
    if hasattr(p, "to_dict"):
        return p.to_dict()
    return {"num_layers": int(p)}


def _refuse_noise(bp: Dict) -> None:
    if bp.get("inject_noise", False):
        raise NotImplementedError("ltx_vae: inject_noise is not ported (no shipped config "
                                  "sets it)")


class LTXEncoder(nn.Module):
    def __init__(self, dims, in_channels: int, latent_channels: int, blocks,
                 base_channels: int = 128, patch_size: int = 1, norm_layer: str = "group_norm",
                 latent_log_var: str = "per_channel"):
        super().__init__()
        self.patch_size = patch_size
        c = base_channels
        self.conv_in = make_conv_nd(dims, in_channels * patch_size ** 2, c, 3, causal=True,
                                    padding=1)
        self.names: List[Tuple[str, str]] = []
        strides = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2),
                   "compress_all": (2, 2, 2), "compress_all_x_y": (2, 2, 2)}
        for i, (block_name, raw) in enumerate(blocks):
            bp = _as_block_params(raw)
            name = f"down_{i}_{block_name}"
            if block_name == "res_x":
                mod = UNetMidBlock3D(dims, c, int(bp["num_layers"]), norm_layer)
            elif block_name == "res_x_y":
                out = int(bp.get("multiplier", 2)) * c
                mod, c = ResnetBlock3D(dims, c, out, norm_layer), out
            elif block_name in strides:
                out = c * (int(bp.get("multiplier", 2)) if block_name == "compress_all_x_y" else 1)
                mod, c = make_conv_nd(dims, c, out, 3, strides=strides[block_name],
                                      causal=True), out
            else:
                raise ValueError(f"unknown encoder block: {block_name}")
            self.add_module(name, mod)
            self.names.append((name, block_name))
        self.conv_norm_out = _Norm(norm_layer, c)
        conv_out = {"per_channel": 2 * latent_channels, "uniform": latent_channels + 1,
                    "none": latent_channels}
        if latent_log_var not in conv_out:
            raise ValueError(f"invalid latent_log_var {latent_log_var}")
        self.conv_out = make_conv_nd(dims, c, conv_out[latent_log_var], 3, causal=True,
                                     padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(patchify(x, self.patch_size))
        for name, _ in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(self.conv_norm_out(x))


class LTXDecoder(nn.Module):
    def __init__(self, dims, latent_channels: int, out_channels: int, blocks,
                 base_channels: int = 128, patch_size: int = 1, norm_layer: str = "group_norm",
                 causal: bool = True):
        super().__init__()
        self.patch_size, self.causal = patch_size, causal
        c = base_channels
        for block_name, raw in blocks:
            bp = _as_block_params(raw)
            if block_name == "res_x_y":
                c *= int(bp.get("multiplier", 2))
            if block_name == "compress_all":
                c *= int(bp.get("multiplier", 1))
        self.conv_in = make_conv_nd(dims, latent_channels, c, 3, causal=True, padding=1)
        self.names: List[str] = []
        for i, (block_name, raw) in enumerate(blocks):
            bp = _as_block_params(raw)
            _refuse_noise(bp)
            name = f"up_{i}_{block_name}"
            if block_name in ("res_x", "attn_res_x"):
                mod = UNetMidBlock3D(dims, c, int(bp["num_layers"]), norm_layer,
                                     int(bp["attention_head_dim"]) if block_name == "attn_res_x"
                                     else -1)
            elif block_name == "res_x_y":
                out = c // int(bp.get("multiplier", 2))
                mod, c = ResnetBlock3D(dims, c, out, norm_layer), out
            elif block_name in ("compress_time", "compress_space"):
                mod = DepthToSpaceUpsample(
                    dims, c, (2, 1, 1) if block_name == "compress_time" else (1, 2, 2))
            elif block_name == "compress_all":
                reduction = int(bp.get("multiplier", 1))
                mod = DepthToSpaceUpsample(dims, c, (2, 2, 2), bool(bp.get("residual", False)),
                                           reduction)
                c //= reduction
            else:
                raise ValueError(f"unknown decoder block: {block_name}")
            self.add_module(name, mod)
            self.names.append(name)
        self.conv_norm_out = _Norm(norm_layer, c)
        self.conv_out = make_conv_nd(dims, c, out_channels * patch_size ** 2, 3, causal=True,
                                     padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z, causal=self.causal)
        for name in self.names:
            x = getattr(self, name)(x, causal=self.causal)
        x = self.conv_out(self.conv_norm_out(x), causal=self.causal)
        return unpatchify(x, self.patch_size)


class _LTXVAEModule(nn.Module):
    """LTXEncoder and LTXDecoder with the optional 1x1x1 quant convs."""

    def __init__(self, config, latent_channels: int):
        super().__init__()
        dims = tuple(config.dims) if isinstance(config.dims, list) else config.dims
        double_z = bool(config.get("double_z", True))
        self.latent_log_var = config.get("latent_log_var",
                                         "per_channel" if double_z else "none")
        self.latent_channels = latent_channels
        self.use_quant_conv = bool(config.get("use_quant_conv", True))
        if self.use_quant_conv and self.latent_log_var == "uniform":
            raise ValueError("uniform latent_log_var requires use_quant_conv=False")
        if bool(config.get("timestep_conditioning", False)):
            raise NotImplementedError("ltx_vae: the timestep-conditioned decoder is not ported "
                                      "(no shipped config sets it)")
        blocks = [tuple(b) for b in config.encoder_blocks], [tuple(b) for b in config.decoder_blocks]
        patch = int(config.get("patch_size", 1))
        norm = config.get("norm_layer", "group_norm")
        self.encoder = LTXEncoder(dims, int(config.get("in_channels", 3)), latent_channels,
                                  blocks[0], patch_size=patch, norm_layer=norm,
                                  latent_log_var=self.latent_log_var)
        self.decoder = LTXDecoder(dims, latent_channels, int(config.get("out_channels", 3)),
                                  blocks[1], patch_size=patch, norm_layer=norm,
                                  causal=bool(config.get("causal_decoder", False)))
        if self.use_quant_conv:
            self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, (1, 1, 1))
            self.post_quant_conv = Conv(latent_channels, latent_channels, (1, 1, 1))

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        h = self.encoder(x)
        if self.latent_log_var == "uniform":
            mean, logvar = h[..., :self.latent_channels], h[..., -1:]
            h = torch.cat([mean, logvar.expand(mean.shape)], dim=-1)
        elif self.latent_log_var == "none":
            h = torch.cat([h, torch.zeros_like(h)], dim=-1)
        return self.quant_conv(h) if self.use_quant_conv else h

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)


class CausalVideoAutoencoder(VariationalAutoEncoder):
    """The LTX-Video VAE on `device` (CUDA unless "cpu")."""

    def __init__(self, config, device=None, **kwargs):
        super().__init__(config, device)
        self.input_number_of_frames = int(config.get("input_number_of_frames", 25))
        self.latent_channels = int(config.latent_channels)
        self.ae = _LTXVAEModule(config, self.latent_channels)
        self._build_loss()
        self._place()

    def fit_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Tiles or clips the frames to input_number_of_frames."""
        f, want = x.shape[1], self.input_number_of_frames
        if f < want:
            x = x.repeat(1, -(-want // f), 1, 1, 1)
        return x[:, :want]
