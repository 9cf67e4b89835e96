"""DDPM/GLIDE-style UNet epsilon-prediction network, NHWC.

Counterpart of xdiffusion_tpu/score_networks/unet.py. Submodules carry the
names of the JAX package's flax parameter paths (`_downs_3_0_1`,
`_middle_1_1`, `_projections_timestep`, `final_norm`, ...), so the weight
bridge (weights.py) maps a flax tree onto this module mechanically.

Conditioning, as in JAX: the `projections` dict (`_projections_<signal>`)
and the context-transformer heads, each called with (context, projections)
before the first stage; heads with parameters (`ContextProjection`,
`GLIDETransformerWrapper`, `PooledTextEmbeddingsToTimestep`) are registered
as `_context_heads_<i>`, their flax names, and a head with `make_projection`
(Gaussian conditioning augmentation, layers/super_resolution.py) adds its
projection as `_projections_<its key>`. Cross-attention layers read the
context the heads leave.

Compute-dtype policy, as in JAX: parameters stay fp32; activations run in
the config's `dtype` (float32 or bfloat16); `final_conv` has no dtype and
promotes to fp32, and the output is fp32. A learned-sigma network
(`is_learned_sigma`) emits twice the input's channels and returns them as
the pair (prediction, log-variance), split along the NHWC channel axis.

Training: where the JAX UNet threads `deterministic` through its stages
(unet.py:202-251), the port uses the module's training mode
(`train()` / `eval()`) and the dropout generator that the context carries
to every stage (`context["dropout_generator"]`, set by `loss_on_batch`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.config import (
    instantiate_from_config,
    instantiate_partial_from_config,
)
from xdiffusion_tpu_torch.layers.linear import ConvNHWC
from xdiffusion_tpu_torch.layers.resnet import (
    Downsample,
    FastGroupNorm,
    ResnetBlockBigGAN,
    Upsample,
    num_groups_for,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Unet(nn.Module):
    """Time-dependent score network on a U-Net backbone; built from the
    score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        dt = DTYPES[cfg.get("dtype", "float32")]
        self.compute_dtype = dt
        num_features = cfg.num_features
        mults = list(cfg.channel_multipliers)
        if cfg.is_class_conditional:
            raise NotImplementedError("class-conditional UNets are not ported yet")
        block_type = cfg.resnet_block_type if "resnet_block_type" in cfg else "biggan"
        if block_type != "biggan":
            raise NotImplementedError(f"resnet_block_type {block_type!r} is not ported yet")
        dropout = float(cfg.dropout) if "dropout" in cfg else 0.0

        self._projections: Dict[str, nn.Module] = {}
        for name in cfg.conditioning.signals:
            proj = instantiate_from_config(cfg.conditioning.projections[name].to_dict())
            self.add_module(f"_projections_{name}", proj)
            self._projections[name] = proj
        head_cfg = cfg.conditioning.context_transformer_head
        head_list = head_cfg if isinstance(head_cfg, list) else [head_cfg.to_dict()]
        self._context_heads = [instantiate_from_config(h) for h in head_list]
        for i, head in enumerate(self._context_heads):
            if isinstance(head, nn.Module):  # heads with parameters (GLIDE, ...)
                self.add_module(f"_context_heads_{i}", head)
            if hasattr(head, "make_projection"):
                # A head that carries its own projection (Gaussian conditioning
                # augmentation) registers it beside the signals' projections.
                proj = head.make_projection()
                self.add_module(f"_projections_{head.projection_key}", proj)
                self._projections[head.projection_key] = proj
        emb_dim = next(
            self._projections[h.projection_key].out_features
            for h in self._context_heads
            if getattr(h, "output_context_key", None) == "timestep_embedding"
        )

        attn_base = instantiate_partial_from_config(
            cfg.conditioning.context_transformer_layer.to_dict()
        )
        s = cfg.input_spatial_size
        width = s[1] if isinstance(s, list) else s
        attention_ds = [width // int(r) for r in cfg.attention.attention_resolutions]
        nblocks = cfg.num_resnet_blocks
        if not isinstance(nblocks, list):
            nblocks = [nblocks] * len(mults)
        use_ss = bool(cfg.use_scale_shift_norm)
        resamp_conv = bool(cfg.resamp_with_conv)
        if cfg.resblock_updown:
            raise NotImplementedError("resblock_updown is not ported yet")

        def res_block(dim_in, dim_out):
            return ResnetBlockBigGAN(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                                     use_conv=resamp_conv, dropout=dropout, dtype=dt)

        def attn(ch):
            return attn_base(in_channels=ch, dtype=dt)

        # Stages are lists of (kind, module); skips are kept after each.
        downs: List[List[Tuple[str, nn.Module]]] = []
        skip_chans = [num_features]
        ch = num_features
        ds = 1
        for level, mult in enumerate(mults):
            for _ in range(nblocks[level]):
                stage = [("res", res_block(ch, mult * num_features))]
                ch = mult * num_features
                if ds in attention_ds:
                    stage.append(("attn", attn(ch)))
                downs.append(stage)
                skip_chans.append(ch)
            if level != len(mults) - 1:
                downs.append([("down", Downsample(ch, with_conv=resamp_conv, dtype=dt))])
                skip_chans.append(ch)
                ds *= 2
        middle = [("res", res_block(ch, ch)), ("attn", attn(ch)), ("res", res_block(ch, ch))]
        ups: List[List[Tuple[str, nn.Module]]] = []
        for level, mult in list(enumerate(mults))[::-1]:
            for i in range(nblocks[level] + 1):
                stage = [("res", res_block(ch + skip_chans.pop(), num_features * mult))]
                ch = num_features * mult
                if ds in attention_ds:
                    stage.append(("attn", attn(ch)))
                if level and i == nblocks[level]:
                    stage.append(("up", Upsample(ch, with_conv=resamp_conv, dtype=dt)))
                    ds //= 2
                ups.append(stage)

        def register(prefix, stage):
            for j, (_, mod) in enumerate(stage):
                self.add_module(f"{prefix}_{j}_1", mod)

        for i, stage in enumerate(downs):
            register(f"_downs_{i}", stage)
        register("_middle", middle)
        for i, stage in enumerate(ups):
            register(f"_ups_{i}", stage)
        self._downs, self._middle, self._ups = downs, middle, ups

        self.initial_conv = ConvNHWC(cfg.input_channels, mults[0] * num_features, 3,
                                     padding=1, bias=False, dtype=dt)
        self.final_norm = FastGroupNorm(num_features, num_groups_for(num_features),
                                        silu=True)
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        out_channels = cfg.input_channels * 2 if self._is_learned_sigma else cfg.output_channels
        self.final_conv = ConvNHWC(num_features, out_channels, 3, padding=1,
                                   bias=False, dtype=None)

    @staticmethod
    def _apply_stage(stage, h, context):
        for kind, mod in stage:
            h = mod(h, context=context)
        return h

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) noisy batch -> (B, H, W, output_channels) fp32, or
        for a learned-sigma network the pair (prediction, log-variance),
        each (B, H, W, input_channels)."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        h = self.initial_conv(x)
        hs = [h]
        for stage in self._downs:
            h = self._apply_stage(stage, h, context)
            hs.append(h)
        h = self._apply_stage(self._middle, h, context)
        for stage in self._ups:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_stage(stage, h, context)
        out = self.final_conv(self.final_norm(h)).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
