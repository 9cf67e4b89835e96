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

Residual blocks are BigGAN or DDPM (`resnet_block_type`); with
`resblock_updown` the resampling stages are residual blocks that resample
(a DDPM block ignores the request, as the JAX package's does).

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
from xdiffusion_tpu_torch.layers.embedding import LabelEmbeddingProjection
from xdiffusion_tpu_torch.layers.linear import ConvNHWC
from xdiffusion_tpu_torch.layers.resnet import (
    Downsample,
    FastGroupNorm,
    ResnetBlockBigGAN,
    ResnetBlockDDPM,
    Upsample,
    num_groups_for,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Unet(nn.Module):
    """Time-dependent score network on a U-Net backbone; built from the
    score_network params block as a DotConfig.

    Hooks for the video wrappers, as in JAX: `_net_config` names the config
    block of the 2-D backbone (Video-LDM and AnimateDiff point it at their
    `spatial_score_network`), and `_post_element` runs after each element of
    each stage, keyed by ("downs" | "middle" | "ups", stage index) and the
    element's index (their temporal modules)."""

    def __init__(self, config: Any):
        super().__init__()
        self.config = config
        cfg = self._net_config()
        dt = DTYPES[cfg.get("dtype", "float32")]
        self.compute_dtype = dt
        num_features = cfg.num_features
        mults = list(cfg.channel_multipliers)
        block_type = cfg.resnet_block_type if "resnet_block_type" in cfg else "biggan"
        dropout = float(cfg.dropout) if "dropout" in cfg else 0.0

        emb_dim = register_conditioning(self, cfg)
        if cfg.is_class_conditional:
            self._label_projection = LabelEmbeddingProjection(cfg.num_classes, num_features * 4)

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
        updown = bool(cfg.resblock_updown)

        def res_block(dim_in, dim_out, **kw):
            if block_type == "biggan":
                return ResnetBlockBigGAN(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                                         use_conv=resamp_conv, dropout=dropout, dtype=dt, **kw)
            # The JAX package's DDPM block takes no resampling (nor its kwargs).
            return ResnetBlockDDPM(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                                   dropout=dropout, dtype=dt)

        def attn(ch):
            return attn_base(in_channels=ch, dtype=dt)

        def resample(kind, ch):
            cls = Downsample if kind == "down" else Upsample
            return cls(ch, with_conv=resamp_conv, dtype=dt)

        downs, middle, ups = build_stages(num_features, mults, nblocks, attention_ds,
                                          res_block, lambda ch: [("attn", attn(ch))],
                                          resample, updown)
        register_stages(self, downs, middle, ups)

        self.initial_conv = ConvNHWC(cfg.input_channels, mults[0] * num_features, 3,
                                     padding=1, bias=False, dtype=dt)
        self.final_norm = FastGroupNorm(num_features, num_groups_for(num_features),
                                        silu=True)
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        out_channels = cfg.input_channels * 2 if self._is_learned_sigma else cfg.output_channels
        self.final_conv = ConvNHWC(num_features, out_channels, 3, padding=1,
                                   bias=False, dtype=None)

    def _net_config(self):
        """The config block of the 2-D backbone."""
        return self.config

    def _apply_stage(self, stage, h, context, stage_key=None):
        for idx, (_, mod) in enumerate(stage):
            h = mod(h, context=context)
            h = self._post_element(h, stage_key, idx, context)
        return h

    def _post_element(self, h, stage_key, elem_idx, context):
        """Runs after element `elem_idx` of stage `stage_key`; the identity."""
        return h

    def _conditioned(self, context: Dict) -> Dict:
        """The context after the heads (timestep and text embeddings)."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        if self._net_config().is_class_conditional and "classes" in context:
            context["class_embedding"] = self._label_projection(context["classes"])
        return context

    def _backbone(self, h: torch.Tensor, context: Dict) -> torch.Tensor:
        """initial_conv -> the stages -> final_norm -> final_conv, fp32."""
        h = self.initial_conv(h)
        hs = [h]
        for i, stage in enumerate(self._downs):
            h = self._apply_stage(stage, h, context, ("downs", i))
            hs.append(h)
        h = self._apply_stage(self._middle, h, context, ("middle", 0))
        for i, stage in enumerate(self._ups):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_stage(stage, h, context, ("ups", i))
        return self.final_conv(self.final_norm(h)).float()

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) noisy batch -> (B, H, W, output_channels) fp32, or
        for a learned-sigma network the pair (prediction, log-variance),
        each (B, H, W, input_channels)."""
        out = self._backbone(x, self._conditioned(context))
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out


def register_conditioning(module: nn.Module, cfg) -> int:
    """Builds the config's conditioning on `module`: the signals'
    projections (`_projections_<signal>`, kept in `_projections`), the
    context heads (`_context_heads`; those with parameters registered as
    `_context_heads_<i>`, a head's own projection as `_projections_<key>`).
    Returns the timestep embedding's width."""
    module._projections = {}
    for name in cfg.conditioning.signals:
        proj = instantiate_from_config(cfg.conditioning.projections[name].to_dict())
        module.add_module(f"_projections_{name}", proj)
        module._projections[name] = proj
    head_cfg = cfg.conditioning.context_transformer_head
    head_list = head_cfg if isinstance(head_cfg, list) else [head_cfg.to_dict()]
    module._context_heads = [instantiate_from_config(h) for h in head_list]
    for i, head in enumerate(module._context_heads):
        if isinstance(head, nn.Module):  # heads with parameters (GLIDE, ...)
            module.add_module(f"_context_heads_{i}", head)
        if hasattr(head, "make_projection"):
            # A head that carries its own projection (Gaussian conditioning
            # augmentation) registers it beside the signals' projections.
            proj = head.make_projection()
            module.add_module(f"_projections_{head.projection_key}", proj)
            module._projections[head.projection_key] = proj
    return next(
        module._projections[h.projection_key].out_features
        for h in module._context_heads
        if getattr(h, "output_context_key", None) == "timestep_embedding"
    )


def build_stages(num_features: int, mults, nblocks, attention_ds, res_block, attn_elems,
                 resample, updown: bool, up_attn_elems=None):
    """The UNet's (downs, middle, ups), lists of stages of (kind, module), as
    the JAX package builds them: `res_block(dim_in, dim_out, **kw)`,
    `attn_elems(ch)` -> the (kind, module) pairs after a residual block at an
    attention resolution (`up_attn_elems(ch)` in the up path when given:
    FDM's `num_heads_upsample`), `resample(kind, ch)` -> a "down" or "up"
    module; with `updown` the resampling stages are residual blocks
    (`down=True`, `up=True`, kind "res_up" for the latter)."""
    downs: List[List[Tuple[str, nn.Module]]] = []
    skip_chans = [num_features]
    ch = num_features
    ds = 1
    for level, mult in enumerate(mults):
        for _ in range(nblocks[level]):
            stage = [("res", res_block(ch, mult * num_features))]
            ch = mult * num_features
            if ds in attention_ds:
                stage.extend(attn_elems(ch))
            downs.append(stage)
            skip_chans.append(ch)
        if level != len(mults) - 1:
            if updown:
                downs.append([("res", res_block(ch, ch, down=True))])
            else:
                downs.append([("down", resample("down", ch))])
            skip_chans.append(ch)
            ds *= 2
    middle = [("res", res_block(ch, ch)), *attn_elems(ch), ("res", res_block(ch, ch))]
    ups: List[List[Tuple[str, nn.Module]]] = []
    for level, mult in list(enumerate(mults))[::-1]:
        for i in range(nblocks[level] + 1):
            stage = [("res", res_block(ch + skip_chans.pop(), num_features * mult))]
            ch = num_features * mult
            if ds in attention_ds:
                stage.extend((up_attn_elems or attn_elems)(ch))
            if level and i == nblocks[level]:
                if updown:
                    stage.append(("res_up", res_block(ch, ch, up=True)))
                else:
                    stage.append(("up", resample("up", ch)))
                ds //= 2
            ups.append(stage)
    return downs, middle, ups


def register_stages(module: nn.Module, downs, middle, ups) -> None:
    """Registers the stages' modules under their flax names
    (`_downs_<i>_<j>_1`, `_middle_<j>_1`, `_ups_<i>_<j>_1`) and keeps the
    stage lists as `_downs`, `_middle`, `_ups`."""

    def register(prefix, stage):
        for j, (_, mod) in enumerate(stage):
            module.add_module(f"{prefix}_{j}_1", mod)

    for i, stage in enumerate(downs):
        register(f"_downs_{i}", stage)
    register("_middle", middle)
    for i, stage in enumerate(ups):
        register(f"_ups_{i}", stage)
    module._downs, module._middle, module._ups = downs, middle, ups
