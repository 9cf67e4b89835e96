"""Flexible Diffusion Modeling's factorized space-time UNet, NHWC frames.

Counterpart of xdiffusion_tpu/score_networks/unet_factorized3d.py, a
network apart from unet_3d:

- frames fold into the batch for a per-frame 2-D UNet, and the timestep
  embedding is computed per frame: GLIDE features at (B*T,), then
  `time_fc1` -> SiLU -> `time_fc2`;
- an input channel marks the observed frames (ones) against the others
  (zeros), and the observed frames are spliced to their clean values
  context["x0"] at the input; `observed_mask` is read when the context
  holds it, else 1 - the latent mask `video_mask` (all frames latent
  without one);
- attention is `FactorizedAttentionBlock` (layers/attention.py): temporal
  RPE attention over explicit frame indices (context["frame_indices"][:, :T],
  arange(T) without them) with the group mask clip(observed + latent),
  then spatial attention in each frame;
- residual blocks are BigGAN blocks through K4 (`use_conv` False) that
  never drop: the JAX network calls them without `deterministic=False`,
  so they run deterministic in training too, and so do they here; the
  final norm is GroupNorm + SiLU through K3, then a zero-initialised
  `final_conv`.

The config's `conditioning` section is not read, as in JAX. Submodules carry
the flax names (`_downs_<i>_<j>_1`, `_middle_<j>_1`, `_ups_<i>_<j>_1`,
`initial_conv`, `time_fc1`, ...), so the weight bridge maps a flax tree
mechanically.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.attention import FactorizedAttentionBlock
from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.layers.resnet import (
    Downsample,
    FastGroupNorm,
    ResnetBlockBigGAN,
    Upsample,
    num_groups_for,
)
from xdiffusion_tpu_torch.score_networks.unet import build_stages, register_stages


class Unet(nn.Module):
    """FDM's factorized 3-D UNet on (B, T, H, W, C); built from the params
    block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = self.config = config
        mc = int(cfg.model_channels)
        self._model_channels = mc
        tdim = mc * 4
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        in_ch = int(cfg.input_channels)
        self._out_channels = in_ch * 2 if self._is_learned_sigma else int(cfg.output_channels)
        dropout = float(cfg.get("dropout", 0.0))
        mults = list(cfg.channel_mult)
        nblocks = int(cfg.num_res_blocks)
        heads = int(cfg.num_heads)
        heads_up = int(cfg.get("num_heads_upsample", -1))
        heads_up = heads if heads_up == -1 else heads_up
        use_ss = bool(cfg.use_scale_shift_norm)
        conv_resample = bool(cfg.get("conv_resample", True))
        use_rpe_net = bool(cfg.get("use_rpe_net", True))
        s = cfg.input_spatial_size
        spatial = int(s[0] if isinstance(s, list) else s)
        attention_ds = [spatial // int(r) for r in cfg.attention_resolutions]

        def res(dim_in, dim_out):
            return ResnetBlockBigGAN(dim_in, dim_out, tdim, use_scale_shift_norm=use_ss,
                                     use_conv=False, dropout=dropout)

        def attn(heads_):
            return lambda ch: [("attn", FactorizedAttentionBlock(ch, heads_, tdim,
                                                                 use_rpe_net=use_rpe_net))]

        def resample(kind, ch):
            return (Downsample if kind == "down" else Upsample)(ch, with_conv=conv_resample)

        register_stages(self, *build_stages(mc, mults, [nblocks] * len(mults), attention_ds,
                                            res, attn(heads), resample, False,
                                            up_attn_elems=attn(heads_up)))

        self.initial_conv = ConvNHWC(in_ch + 1, mc, 3, padding=1)
        self.time_fc1 = Dense(mc, tdim)
        self.time_fc2 = Dense(tdim, tdim)
        self.final_norm = FastGroupNorm(mc, num_groups_for(mc), silu=True)
        self.final_conv = ConvNHWC(mc, self._out_channels, 3, padding=1)
        nn.init.zeros_(self.final_conv.weight)

    def _apply_stage(self, stage, h, res_context, temb, frame_indices, attn_mask, t):
        for kind, mod in stage:
            if kind == "res":
                h = mod(h, context=res_context)
            elif kind == "attn":
                h = mod(h, temb=temb, frame_indices=frame_indices, attn_mask=attn_mask,
                        frames=t)
            else:  # down / up
                h = mod(h)
        return h

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, T, H, W, C) noisy video -> (B, T, H, W, output_channels)
        fp32, or the pair (prediction, log-variance) for a learned-sigma
        network. Context: timestep (B,); optional frame_indices (B, >= T),
        video_mask (B, >= T) (True: generate), observed_mask (B, >= T) and
        x0 (B, T, H, W, C) clean frames."""
        b, t, hh, ww, c = x.shape
        device = x.device
        frame_indices = context.get("frame_indices")
        if frame_indices is None:
            frame_indices = torch.arange(t, device=device).expand(b, t)
        frame_indices = torch.as_tensor(frame_indices, device=device)[:, :t]
        if context.get("video_mask") is not None:
            latent = torch.as_tensor(context["video_mask"], device=device)[:, :t].float()
        else:
            latent = torch.ones((b, t), device=device)
        if context.get("observed_mask") is not None:
            observed = torch.as_tensor(context["observed_mask"], device=device)[:, :t].float()
        else:
            observed = 1.0 - latent
        attn_mask = (observed + latent).clamp(0.0, 1.0)

        x0 = context.get("x0")
        x0 = torch.zeros_like(x) if x0 is None else x0[:, :t].to(x.dtype)
        m = observed[:, :, None, None, None]
        h = torch.cat([x * (1.0 - m) + x0 * m, m.expand(b, t, hh, ww, 1).to(x.dtype)], dim=-1)
        h = h.reshape(b * t, hh, ww, c + 1)

        # One diffusion time per example, embedded per frame at (B*T,).
        steps = torch.as_tensor(context["timestep"], device=device).float()
        t_bt = steps[:, None].expand(b, t).reshape(b * t)
        emb = self.time_fc2(F.silu(self.time_fc1(
            glide_timestep_embedding(t_bt, self._model_channels))))
        temb = emb.reshape(b, t, -1)
        res_context = {"timestep_embedding": emb}
        args = (res_context, temb, frame_indices, attn_mask, t)

        h = self.initial_conv(h)
        hs = [h]
        for stage in self._downs:
            h = self._apply_stage(stage, h, *args)
            hs.append(h)
        h = self._apply_stage(self._middle, h, *args)
        for stage in self._ups:
            h = self._apply_stage(stage, torch.cat([h, hs.pop()], dim=-1), *args)
        out = self.final_conv(self.final_norm(h)).float().reshape(b, t, hh, ww, -1)
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out


# The shipped configs use the UNet capitalisation.
UNet = Unet
