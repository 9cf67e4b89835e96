"""EDM score networks: the SongUNet and DhariwalUNet backbones and the
VP, VE, iDDPM and EDM preconditioners.

Counterpart of xdiffusion_tpu/score_networks/edm.py, NHWC like it, with its
module names (enc_{res}x{res}_block{i}, dec_..._up, ...), so flax parameters
map mechanically (weights.py). Inside the blocks:

- GroupNorm (+ SiLU) goes through `layers.resnet.FastGroupNorm`, and so
  through K3; its adaptive scale-shift (the ADM blocks) through the plain
  `group_norm_scale_shift`, as in the JAX package. Group counts are EDM's,
  min(32, C // 4); eps 1e-6 in the Song blocks, 1e-5 elsewhere.
- Self-attention goes through `ops.attention.attention_qkv`, and so through
  K1 (its gradient K2): one head of C in the Song blocks (head dim 256 at
  the shipped width), C / 64 heads in the ADM blocks.
- The 3x3 convolutions are `F.conv2d`, as the JAX package runs them as
  `nn.Conv` outside any kernel; the resampling filters are depthwise
  convolutions of the normalised outer product of the 1-D filter.

The preconditioners are `nn.Module`s that own the backbone (`model`) and
compute c_skip, c_out, c_in and c_noise in fp32. The Fourier embedding's
frequencies, a parameter under stop_gradient in the JAX package, are a
buffer here: no gradient and no optimizer update reaches them, and the
JAX package's default Adam (no weight decay) leaves them unchanged too.
Dropout draws from a `torch.Generator` while the module trains.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config
from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm
from xdiffusion_tpu_torch.ops.attention import attention_qkv
from xdiffusion_tpu_torch.utils import dropout

# ---- noise-level embeddings ---------------------------------------------------


class PositionalEmbedding(nn.Module):
    """DDPM++ / ADM sinusoidal embedding of the noise level (cos first;
    endpoint=True divides by half - 1)."""

    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels = num_channels
        self.max_positions = max_positions
        self.endpoint = endpoint

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device) / (
            half - (1 if self.endpoint else 0))
        freqs = (1.0 / self.max_positions) ** freqs
        args = x[:, None].float() * freqs[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class FourierEmbedding(nn.Module):
    """NCSN++ random Fourier features; `freqs` is a buffer (see the module
    docstring)."""

    def __init__(self, num_channels: int, scale: float = 16.0):
        super().__init__()
        self.register_buffer("freqs", torch.randn(num_channels // 2) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = 2.0 * math.pi * x[:, None].float() * self.freqs[None, :]
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


# ---- filtered resampling --------------------------------------------------------


def _make_filter_2d(f: Sequence[float]) -> np.ndarray:
    f = np.asarray(f, dtype=np.float32)
    f = f / f.sum()
    return np.outer(f, f)


def _depthwise_weight(k2: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The (C, 1, n, n) depthwise weight of filter k2 for NHWC x."""
    w = torch.from_numpy(np.ascontiguousarray(k2)).to(device=x.device, dtype=x.dtype)
    return w[None, None].expand(x.shape[-1], 1, *k2.shape)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resample_down(x: torch.Tensor, filt: Sequence[float]) -> torch.Tensor:
    """The normalised filter at stride 2 (JAX: a depthwise conv, padding
    (n - 1) // 2)."""
    k2 = _make_filter_2d(filt)
    pad = (k2.shape[0] - 1) // 2
    return _nhwc(F.conv2d(_nchw(x), _depthwise_weight(k2, x), stride=2, padding=pad,
                          groups=x.shape[-1]))


def resample_up(x: torch.Tensor, filt: Sequence[float]) -> torch.Tensor:
    """Zero insertion and 4x the normalised filter (JAX: lhs_dilation 2,
    padding n // 2), as a transposed depthwise convolution; the filter is
    symmetric, so its flip is itself."""
    k2 = _make_filter_2d(filt) * 4.0
    n = k2.shape[0]
    return _nhwc(F.conv_transpose2d(_nchw(x), _depthwise_weight(k2, x), stride=2,
                                    padding=n - 1 - n // 2, groups=x.shape[-1]))


# ---- the UNet block ---------------------------------------------------------------


def _edm_groups(c: int) -> int:
    """EDM's GroupNorm group count: min(32, channels // 4)."""
    return max(1, min(32, c // 4))


class UNetBlockEDM(nn.Module):
    """Residual block with optional resampling and self-attention: the DDPM++,
    NCSN++ and ADM design points (see the JAX block)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 num_heads: Optional[int] = None, channels_per_head: int = 64,
                 dropout: float = 0.0, skip_scale: float = 1.0, adaptive_scale: bool = False,
                 resample_proj: bool = False, eps: float = 1e-5,
                 resample_filter: Tuple[float, ...] = (1, 1)):
        super().__init__()
        self.up, self.down, self.attention = up, down, attention
        self.dropout = dropout
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.resample_filter = tuple(resample_filter)
        self.norm0 = FastGroupNorm(in_channels, _edm_groups(in_channels), eps, silu=True)
        self.conv0 = ConvNHWC(in_channels, out_channels, 3, padding=1)
        self.affine = Dense(emb_channels, 2 * out_channels if adaptive_scale else out_channels)
        self.norm1 = FastGroupNorm(out_channels, _edm_groups(out_channels), eps, silu=True)
        self.conv1 = ConvNHWC(out_channels, out_channels, 3, padding=1)
        self.skip = None
        if in_channels != out_channels or ((up or down) and resample_proj):
            self.skip = ConvNHWC(in_channels, out_channels, 1)
        if attention:
            self.num_heads = (num_heads if num_heads is not None
                              else max(1, out_channels // channels_per_head))
            self.norm2 = FastGroupNorm(out_channels, _edm_groups(out_channels), eps)
            self.qkv = Dense(out_channels, 3 * out_channels)
            self.proj = Dense(out_channels, out_channels, zero_init=True)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.contiguous()  # K3 reads NHWC rows in place
        h = self.norm0(x)
        if self.up:
            h, x = resample_up(h, self.resample_filter), resample_up(x, self.resample_filter)
        elif self.down:
            h, x = (resample_down(h, self.resample_filter),
                    resample_down(x, self.resample_filter))
        h = self.conv0(h)
        emb_out = self.affine(emb)[:, None, None, :]
        if self.adaptive_scale:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.norm1(h, t_scale=scale, t_shift=shift)
        else:
            h = self.norm1((h + emb_out).contiguous())
        if self.dropout > 0.0 and self.training and generator is not None:
            h = dropout(h, self.dropout, generator)
        h = self.conv1(h)
        if self.skip is not None:
            x = self.skip(x)
        x = (x + h) * self.skip_scale
        if self.attention:
            b, hh, ww, cc = x.shape
            n = self.norm2(x.contiguous())
            q, k, v = self.qkv(n.reshape(b, hh * ww, cc)).chunk(3, dim=-1)
            a = self.proj(attention_qkv(q, k, v, heads=self.num_heads))
            x = (x + a.reshape(b, hh, ww, cc)) * self.skip_scale
        return x


class FusedDownConv(nn.Module):
    """A 3x3 conv with padding widened by the filter's, then the normalised
    filter at stride 2 (NCSN++'s residual-encoder projection)."""

    def __init__(self, in_channels: int, out_channels: int,
                 resample_filter: Tuple[float, ...] = (1, 1)):
        super().__init__()
        self.k2 = _make_filter_2d(resample_filter)
        self.conv = ConvNHWC(in_channels, out_channels, 3,
                             padding=1 + (self.k2.shape[0] - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return _nhwc(F.conv2d(_nchw(h), _depthwise_weight(self.k2, h), stride=2,
                              groups=h.shape[-1]))


# ---- the backbones -------------------------------------------------------------


class _Backbone(nn.Module):
    """The encoder/decoder walk both backbones share: `_enc` and `_dec` list
    (kind, name) pairs of registered submodules."""

    def _block(self, kind: str, name: str, module: nn.Module, stage: list) -> None:
        self.add_module(name, module)
        stage.append((kind, name))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        return self.out_conv(self.out_norm(h.contiguous())).float()


class SongUNet(_Backbone):
    """DDPM++ and NCSN++ (positional or Fourier embedding; standard or
    residual encoder)."""

    def __init__(self, **params):
        super().__init__()
        cfg = DotConfig(params)
        mc = int(cfg.model_channels)
        emb_ch = mc * int(cfg.get("channel_mult_emb", 4))
        noise_ch = mc * int(cfg.get("channel_mult_noise", 1))
        mults = list(cfg.channel_mult)
        num_blocks = int(cfg.get("num_blocks", 4))
        attn_res = list(cfg.get("attn_resolutions", []) or [])
        dropout_rate = float(cfg.get("dropout", 0.10))
        self.label_dim = int(cfg.get("label_dim", 0))
        self.augment_dim = int(cfg.get("augment_dim", 0))
        embedding_type = cfg.get("embedding_type", "positional")
        self.encoder_type = cfg.get("encoder_type", "standard")
        decoder_type = cfg.get("decoder_type", "standard")
        filt = tuple(cfg.get("resample_filter", [1, 1]))
        res0 = int(cfg.img_resolution)
        in_ch = int(cfg.get("in_channels", 1))
        if self.encoder_type == "skip" or decoder_type == "skip":
            raise NotImplementedError("encoder/decoder_type 'skip' is not in the JAX package")
        skip_scale = float(np.sqrt(0.5))

        if embedding_type == "fourier":
            self.map_noise = FourierEmbedding(noise_ch)
        else:
            self.map_noise = PositionalEmbedding(noise_ch, endpoint=True)
        self.map_layer0 = Dense(noise_ch, emb_ch)
        self.map_layer1 = Dense(emb_ch, emb_ch)
        if self.label_dim:
            self.map_label = Dense(self.label_dim, noise_ch)
        if self.augment_dim:
            self.map_augment = Dense(self.augment_dim, noise_ch, bias=False)

        def block(cin, cout, **kw):
            # The Song blocks: one head, eps 1e-6, a 1x1 skip on resampling.
            return UNetBlockEDM(cin, cout, emb_ch, dropout=dropout_rate, skip_scale=skip_scale,
                                num_heads=1, eps=1e-6, resample_proj=True,
                                resample_filter=filt, **kw)

        self._enc, self._dec = [], []
        cout = mc
        res = res0
        self._block("conv_in", f"enc_{res}x{res}_conv", ConvNHWC(in_ch, cout, 3, padding=1),
                    self._enc)
        skip_channels = [cout]
        for level, mult in enumerate(mults):
            res = res0 >> level
            if level > 0:
                self._block("down", f"enc_{res}x{res}_down", block(cout, cout, down=True),
                            self._enc)
                skip_channels.append(cout)
                if self.encoder_type == "residual":
                    self._block("aux_residual", f"enc_{res}x{res}_aux_residual",
                                FusedDownConv(in_ch if level == 1 else cout, cout, filt),
                                self._enc)
            for i in range(num_blocks):
                cin, cout = cout, mc * mult
                self._block("block", f"enc_{res}x{res}_block{i}",
                            block(cin, cout, attention=res in attn_res), self._enc)
                skip_channels.append(cout)
        for level, mult in reversed(list(enumerate(mults))):
            res = res0 >> level
            if level == len(mults) - 1:
                self._block("block", f"dec_{res}x{res}_in0", block(cout, cout, attention=True),
                            self._dec)
                self._block("block", f"dec_{res}x{res}_in1", block(cout, cout), self._dec)
            else:
                self._block("up", f"dec_{res}x{res}_up", block(cout, cout, up=True), self._dec)
            for i in range(num_blocks + 1):
                cin, cout = cout + skip_channels.pop(), mc * mult
                attn = i == num_blocks and res in attn_res
                self._block("skip_block", f"dec_{res}x{res}_block{i}",
                            block(cin, cout, attention=attn), self._dec)
        self.out_norm = FastGroupNorm(cout, _edm_groups(cout), 1e-6, silu=True)
        self.out_conv = ConvNHWC(cout, int(cfg.out_channels), 3, padding=1)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.map_noise(noise_labels)
        half = emb.shape[1] // 2
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=1)  # sin first
        if self.label_dim and class_labels is not None:
            one_hot = F.one_hot(class_labels.long(), self.label_dim).float()
            emb = emb + self.map_label(one_hot * math.sqrt(self.label_dim))
        if self.augment_dim and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))

        skips, aux, h = [], x, x
        for kind, name in self._enc:
            mod = getattr(self, name)
            if kind == "conv_in":
                h = mod(h)
                skips.append(h)
            elif kind == "aux_residual":
                # The merged stream becomes the next aux input and the skip.
                h = (h + mod(aux)) * float(np.sqrt(0.5))
                aux = h
                skips[-1] = h
            else:
                h = mod(h, emb, generator)
                skips.append(h)
        for kind, name in self._dec:
            if kind == "skip_block":
                h = torch.cat([h, skips.pop()], dim=-1)
            h = getattr(self, name)(h, emb, generator)
        return self._head(h)


class DhariwalUNet(_Backbone):
    """ADM: adaptive scale-shift conditioning, C / 64 heads."""

    def __init__(self, **params):
        super().__init__()
        cfg = DotConfig(params)
        mc = int(cfg.model_channels)
        emb_ch = mc * int(cfg.get("channel_mult_emb", 4))
        mults = list(cfg.channel_mult)
        num_blocks = int(cfg.get("num_blocks", 3))
        attn_res = list(cfg.get("attn_resolutions", []) or [])
        dropout_rate = float(cfg.get("dropout", 0.10))
        self.label_dim = int(cfg.get("label_dim", 0))
        self.augment_dim = int(cfg.get("augment_dim", 0))
        res0 = int(cfg.img_resolution)
        in_ch = int(cfg.get("in_channels", 1))

        self.map_noise = PositionalEmbedding(mc)
        self.map_layer0 = Dense(mc, emb_ch)
        self.map_layer1 = Dense(emb_ch, emb_ch)
        if self.label_dim:
            self.map_label = Dense(self.label_dim, emb_ch, bias=False)
        if self.augment_dim:
            self.map_augment = Dense(self.augment_dim, mc, bias=False)

        def block(cin, cout, **kw):
            return UNetBlockEDM(cin, cout, emb_ch, dropout=dropout_rate, skip_scale=1.0,
                                adaptive_scale=True, channels_per_head=64, **kw)

        self._enc, self._dec = [], []
        cout = mc * mults[0]
        res = res0
        self._block("conv_in", f"enc_{res}x{res}_conv", ConvNHWC(in_ch, cout, 3, padding=1),
                    self._enc)
        skip_channels = [cout]
        for level, mult in enumerate(mults):
            res = res0 >> level
            if level > 0:
                self._block("down", f"enc_{res}x{res}_down", block(cout, cout, down=True),
                            self._enc)
                skip_channels.append(cout)
            for i in range(num_blocks):
                cin, cout = cout, mc * mult
                self._block("block", f"enc_{res}x{res}_block{i}",
                            block(cin, cout, attention=res in attn_res), self._enc)
                skip_channels.append(cout)
        for level, mult in reversed(list(enumerate(mults))):
            res = res0 >> level
            if level == len(mults) - 1:
                self._block("block", f"dec_{res}x{res}_in0", block(cout, cout, attention=True),
                            self._dec)
                self._block("block", f"dec_{res}x{res}_in1", block(cout, cout), self._dec)
            else:
                self._block("up", f"dec_{res}x{res}_up", block(cout, cout, up=True), self._dec)
            for i in range(num_blocks + 1):
                cin, cout = cout + skip_channels.pop(), mc * mult
                self._block("skip_block", f"dec_{res}x{res}_block{i}",
                            block(cin, cout, attention=res in attn_res), self._dec)
        self.out_norm = FastGroupNorm(cout, _edm_groups(cout), silu=True)
        self.out_conv = ConvNHWC(cout, int(cfg.out_channels), 3, padding=1)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.map_noise(noise_labels)
        if self.augment_dim and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        emb = self.map_layer1(F.silu(self.map_layer0(emb)))
        if self.label_dim and class_labels is not None:
            emb = emb + self.map_label(F.one_hot(class_labels.long(), self.label_dim).float())
        emb = F.silu(emb)
        skips, h = [], x
        for kind, name in self._enc:
            mod = getattr(self, name)
            h = mod(h) if kind == "conv_in" else mod(h, emb, generator)
            skips.append(h)
        for kind, name in self._dec:
            if kind == "skip_block":
                h = torch.cat([h, skips.pop()], dim=-1)
            h = getattr(self, name)(h, emb, generator)
        return self._head(h)


# ---- the preconditioners -------------------------------------------------------------


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class _Precond(nn.Module):
    """D(x, sigma) = c_skip x + c_out F(c_in x, c_noise) (EDM, Table 1), the
    sigma math in fp32. `model` is the backbone; flax parameters of the
    backbone load under it (`flax_param_prefix`)."""

    flax_param_prefix = "model."

    def __init__(self, model: Dict, label_dim: int = 0, **_):
        super().__init__()
        self.model = instantiate_from_config(model)
        self.label_dim = int(label_dim)
        self.sigma_min = 0.0
        self.sigma_max = float("inf")

    def coefficients(self, sigma: torch.Tensor):
        raise NotImplementedError

    def round_sigma(self, sigma):
        return _f32(sigma)

    def forward(self, x: torch.Tensor, sigma, class_labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, H, W, C); sigma a scalar or (B,). The backbone drops with
        `generator` while the module trains."""
        sigma = _f32(sigma, x.device).reshape(-1).expand(x.shape[0])
        c_skip, c_out, c_in, c_noise = self.coefficients(sigma)

        def expand(c):
            return c.reshape((-1,) + (1,) * (x.ndim - 1))

        labels = class_labels if self.label_dim else None
        fx = self.model(expand(c_in) * x, c_noise, class_labels=labels, generator=generator)
        return expand(c_skip) * x + expand(c_out) * fx


class VPPrecond(_Precond):
    """Variance-preserving (DDPM) preconditioning."""

    def __init__(self, beta_d: float = 19.9, beta_min: float = 0.1, M: int = 1000,
                 epsilon_t: float = 1e-5, **kwargs):
        super().__init__(**kwargs)
        self.beta_d = float(beta_d)
        self.beta_min = float(beta_min)
        self.M = int(M)
        self.epsilon_t = float(epsilon_t)
        self.sigma_min = float(self.sigma(epsilon_t))
        self.sigma_max = float(self.sigma(1.0))

    def sigma(self, t):
        t = _f32(t)
        return torch.sqrt(torch.exp(0.5 * self.beta_d * t ** 2 + self.beta_min * t) - 1.0)

    def sigma_inv(self, sigma):
        sigma = _f32(sigma)
        return (torch.sqrt(self.beta_min ** 2 + 2 * self.beta_d * torch.log1p(sigma ** 2))
                - self.beta_min) / self.beta_d

    def coefficients(self, sigma):
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = (self.M - 1) * self.sigma_inv(sigma)
        return c_skip, c_out, c_in, c_noise


class VEPrecond(_Precond):
    """Variance-exploding (SMLD / NCSN) preconditioning."""

    def __init__(self, sigma_min: float = 0.02, sigma_max: float = 100.0, **kwargs):
        super().__init__(**kwargs)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def coefficients(self, sigma):
        return (torch.ones_like(sigma), sigma, torch.ones_like(sigma),
                torch.log(0.5 * sigma))


class iDDPMPrecond(_Precond):
    """Improved-DDPM preconditioning on the cosine alpha-bar sigma table u
    (float64 on the host, kept in fp32)."""

    def __init__(self, C_1: float = 0.001, C_2: float = 0.008, M: int = 1000, **kwargs):
        super().__init__(**kwargs)
        self.C_1, self.C_2, self.M = float(C_1), float(C_2), int(M)
        u = np.zeros(M + 1, dtype=np.float64)

        def alpha_bar(j):
            return np.sin(0.5 * np.pi * j / (M * (C_2 + 1))) ** 2

        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt((u[j] ** 2 + 1.0) / max(alpha_bar(j - 1) / alpha_bar(j), C_1)
                               - 1.0)
        self.register_buffer("u", torch.from_numpy(u.astype(np.float32)), persistent=False)
        self.sigma_min = float(u[M - 1])
        self.sigma_max = float(u[0])

    def round_sigma(self, sigma, return_index: bool = False):
        """The nearest entry of u (fp32 distances, the first on a tie), or its
        index."""
        u = self.u
        sigma = _f32(sigma, u.device).reshape(-1)
        index = torch.argmin(torch.abs(sigma[:, None] - u[None, :]), dim=1)
        return index if return_index else u[index]

    def coefficients(self, sigma):
        c_skip = 1.0 / (sigma ** 2 + 1.0)
        c_out = -sigma / torch.sqrt(sigma ** 2 + 1.0)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = (self.M - 1 - self.round_sigma(sigma, return_index=True)).float()
        return c_skip, c_out, c_in, c_noise


class EDMPrecond(_Precond):
    """EDM preconditioning."""

    def __init__(self, sigma_min: float = 0.0, sigma_max: float = float("inf"),
                 sigma_data: float = 0.5, **kwargs):
        for key in ("img_resolution", "img_channels", "use_fp16"):
            kwargs.pop(key, None)
        super().__init__(**kwargs)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.sigma_data = float(sigma_data)

    def coefficients(self, sigma):
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sd2 + sigma ** 2)
        c_noise = 0.25 * torch.log(sigma)
        return c_skip, c_out, c_in, c_noise
