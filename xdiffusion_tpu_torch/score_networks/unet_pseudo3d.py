"""Pseudo-3D UNet (Make-A-Video), NHWC frames.

Counterpart of xdiffusion_tpu/score_networks/unet_pseudo3d.py: the video
UNet's stage walk (score_networks/unet_3d.py) over a per-frame 2-D UNet
whose every convolution (initial, each residual block's two, the skip on a
change of width, final) is followed by a kernel-1 "temporal" convolution,
that is a Dense channel mixer at every position, initialised to the
identity, so the model starts as its image counterpart. GroupNorm
statistics are per frame: norm1 and the final norm go through K3, conv2 of
each block through K4 with norm2's scale-shift coefficients (its temporal
mixer sits between conv2 and the residual add, so K4 adds no residual).
Each attention site is one `SpatialAndTemporalCrossAttention`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.config import instantiate_partial_from_config
from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.layers.resnet import (
    Downsample,
    FastGroupNorm,
    FusedAffineConv,
    Upsample,
    avg_pool_2x,
    dropout_generator,
    nearest_upsample_2x,
    num_groups_for,
)
from xdiffusion_tpu_torch.score_networks import unet_3d
from xdiffusion_tpu_torch.score_networks.unet import (
    build_stages,
    register_conditioning,
    register_stages,
)
from xdiffusion_tpu_torch.utils import dropout


def temporal_mix(c: int, bias: bool = True) -> Dense:
    """The kernel-1 temporal Conv1d as a Dense channel mixer, initialised to
    the identity (torch's `dirac_`)."""
    layer = Dense(c, c, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(torch.eye(c))
    return layer


class ResnetBlockBigGANPseudo3D(nn.Module):
    """BigGAN block on frame-folded (B*F, H, W, C) maps with a temporal mixer
    after each convolution; per-frame norms."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int,
                 use_scale_shift_norm: bool = True, use_conv: bool = False,
                 up: bool = False, down: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dim_out = dim_out
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.dropout = dropout
        self.norm1 = FastGroupNorm(dim_in, num_groups_for(dim_in), silu=True)
        self.conv1 = ConvNHWC(dim_in, dim_out, 3, padding=1)
        self.t_conv1 = temporal_mix(dim_out)
        self.emb_proj = Dense(emb_dim, 2 * dim_out if use_scale_shift_norm else dim_out)
        self.norm2 = FastGroupNorm(dim_out, num_groups_for(dim_out), silu=True)
        self.conv2 = FusedAffineConv(dim_out, dim_out, zero_init=True)
        self.t_conv2 = temporal_mix(dim_out)
        if dim_in != dim_out:
            k = 3 if use_conv else 1
            self.skip = ConvNHWC(dim_in, dim_out, k, padding=k // 2)
            self.t_skip = temporal_mix(dim_out)
        else:
            self.skip = None

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        h = self.norm1(x)
        if self.up or self.down:
            resample = nearest_upsample_2x if self.up else avg_pool_2x
            h, x = resample(h), resample(x)
        h = self.t_conv1(self.conv1(h))
        emb = context["timestep_embedding"]
        if "class_embedding" in context:
            emb = emb + context["class_embedding"]
        emb_out = self.emb_proj(torch.nn.functional.silu(emb))[:, None, None, :]
        generator = dropout_generator(self, context)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            norm2 = dict(t_scale=scale, t_shift=shift)
        else:
            norm2 = dict(channel_shift=emb_out)
        if generator is not None and self.dropout > 0.0:
            h = self.norm2(h + emb_out) if "channel_shift" in norm2 else self.norm2(h, **norm2)
            h = self.conv2.plain(dropout(h, self.dropout, generator))
        else:
            h = self.conv2(h, *self.norm2(h, return_coefficients=True, **norm2))
        h = self.t_conv2(h)
        if self.skip is not None:
            x = self.t_skip(self.skip(x))
        return x + h


class Unet(unet_3d.Unet):
    """Make-A-Video's pseudo-3D UNet: the video UNet's stage walk, stages of
    [res, fused spatial + temporal attention], temporal mixers after the
    initial and final convolutions."""

    def __init__(self, config: Any):
        nn.Module.__init__(self)
        cfg = self.config = config
        self._num_frames = int(cfg.input_number_of_frames)
        dropout = float(cfg.dropout) if "dropout" in cfg else 0.0
        emb_dim = register_conditioning(self, cfg)
        unet_3d.register_label_projection(self, cfg)
        cond = cfg.conditioning
        attn_cfg = (cond.spatial_and_temporal_context_transformer_layer
                    if "spatial_and_temporal_context_transformer_layer" in cond
                    else cond.spatial_context_transformer_layer)
        attn = instantiate_partial_from_config(attn_cfg.to_dict())
        mults, nblocks, attention_ds = unet_3d.stage_layout(cfg)
        use_ss = bool(cfg.use_scale_shift_norm)
        resamp_conv = bool(cfg.resamp_with_conv)

        def res_block(dim_in, dim_out, **kw):
            return ResnetBlockBigGANPseudo3D(dim_in, dim_out, emb_dim,
                                             use_scale_shift_norm=use_ss,
                                             use_conv=resamp_conv, dropout=dropout, **kw)

        def resample(kind, ch):
            return (Downsample if kind == "down" else Upsample)(ch, with_conv=resamp_conv)

        register_stages(self, *build_stages(
            cfg.num_features, mults, nblocks, attention_ds, res_block,
            lambda ch: [("attn_s", attn(in_channels=ch))], resample,
            bool(cfg.resblock_updown)))
        self._build_ends(cfg, stat_frames=1)
        self.initial_temporal = temporal_mix(cfg.num_features * mults[0], bias=False)
        self.final_temporal = temporal_mix(self._output_channels, bias=False)

    def _initial(self, h):
        return self.initial_temporal(self.initial_conv(h))

    def _final(self, h):
        return self.final_temporal(self.final_conv(self.final_norm(h)))
