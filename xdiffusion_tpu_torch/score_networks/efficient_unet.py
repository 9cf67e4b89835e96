"""Imagen's Efficient UNet, NHWC.

Counterpart of xdiffusion_tpu/score_networks/efficient_unet.py (Imagen
appendix figures A.27-A.29): D-blocks downsample first (a stride-2 3x3 conv,
symmetric padding 1) and then add the timestep once and run time-free
residual blocks; U-blocks mirror them and upsample last (nearest, then a 3x3
conv); the residual blocks scale (skip + branch) by 0.7071; the D-blocks'
outputs join the U-blocks by concatenation, the deepest one directly. So at
32 pixels with four levels the maps run 16, 8, 4 and 2 wide, and
`attention_resolutions: [16]` places attention in `down_1` and `up_1`, on
the 8x8 maps.

Submodules carry the JAX package's flax parameter paths (`down_{l}/res_{i}/
conv1`, `up_{l}/up_conv`, `_projections_<signal>`, `_context_heads_<i>`,
`initial_conv`, `final_norm`, `final_conv`), so the weight bridge
(weights.py) maps a flax tree mechanically; a head with `make_projection`
(Gaussian conditioning augmentation) registers its projection as
`_projections_<its key>`, as the JAX network does.

Every GroupNorm (32 groups, or C // 4 where 32 does not divide C) and its
SiLU run through K3 (ops/group_norm.py); the convolutions are plain
`F.conv2d`, as XLA runs the JAX package's `nn.Conv`; attention is the
config's layer (`SpatialCrossAttention`, on K1/K2). Dropout draws from the
context's generator in training mode, as elsewhere in the port
(layers/resnet.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.config import instantiate_from_config, instantiate_partial_from_config
from xdiffusion_tpu_torch.layers.embedding import LabelEmbeddingProjection
from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.layers.resnet import (
    FastGroupNorm,
    dropout_generator,
    nearest_upsample_2x,
    num_groups_for,
)
from xdiffusion_tpu_torch.utils import dropout as drop


def _gn(c: int, silu: bool = False) -> FastGroupNorm:
    return FastGroupNorm(c, num_groups_for(c), silu=silu)


class ResnetBlockEfficient(nn.Module):
    """Time-free residual block: conv1(gn_silu(x)), gn_silu, dropout, the
    zero-initialised conv2, plus a 1x1 `skip` of x, times 0.7071."""

    def __init__(self, dim_in: int, dim_out: int, dropout: float = 0.0,
                 scale_skip_connection: bool = True):
        super().__init__()
        self.dropout = dropout
        self.scale_skip_connection = scale_skip_connection
        self.norm1 = _gn(dim_in, silu=True)
        self.conv1 = ConvNHWC(dim_in, dim_out, 3, padding=1)
        self.norm2 = _gn(dim_out, silu=True)
        self.conv2 = ConvNHWC(dim_out, dim_out, 3, padding=1)
        nn.init.zeros_(self.conv2.weight)
        self.skip = ConvNHWC(dim_in, dim_out, 1)

    def forward(self, x: torch.Tensor, context: Optional[Dict] = None) -> torch.Tensor:
        h = self.norm2(self.conv1(self.norm1(x)))
        generator = dropout_generator(self, context)
        if generator is not None:
            h = drop(h, self.dropout, generator)
        out = self.skip(x) + self.conv2(h)
        return out * 0.7071 if self.scale_skip_connection else out


class _Block(nn.Module):
    """What a D-block and a U-block share: the timestep (plus a class
    embedding, when the context has one) added through `emb_proj`, then
    the residual blocks, then the attention layer."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int, num_resnet_blocks: int,
                 dropout: float, attention):
        super().__init__()
        self.emb_proj = Dense(emb_dim, dim_in)
        self._res = []
        for i in range(num_resnet_blocks):
            block = ResnetBlockEfficient(dim_in if i == 0 else dim_out, dim_out, dropout)
            self.add_module(f"res_{i}", block)
            self._res.append(block)
        self.attn = attention(dim_out) if attention is not None else None

    def _body(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        emb = context["timestep_embedding"]
        if "class_embedding" in context:
            emb = emb + context["class_embedding"]
        h = x + self.emb_proj(F.silu(emb))[:, None, None, :]
        for block in self._res:
            h = block(h, context)
        return h if self.attn is None else self.attn(h, context=context)


class DBlock(_Block):
    """Downsample (`down_conv`) -> + time -> residual blocks -> attention."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int, num_resnet_blocks: int,
                 dropout: float = 0.0, attention=None):
        super().__init__(dim_in, dim_out, emb_dim, num_resnet_blocks, dropout, attention)
        self.down_conv = ConvNHWC(dim_in, dim_in, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        return self._body(self.down_conv(x), context)


class UBlock(_Block):
    """+ time -> residual blocks -> attention -> upsample (`up_conv`)."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int, num_resnet_blocks: int,
                 dropout: float = 0.0, attention=None):
        super().__init__(dim_in, dim_out, emb_dim, num_resnet_blocks, dropout, attention)
        self.up_conv = ConvNHWC(dim_out, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        return self.up_conv(nearest_upsample_2x(self._body(x, context)))


class Unet(nn.Module):
    """The Efficient UNet, built from the score_network params block as a
    DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        num_features = cfg.num_features
        mults = list(cfg.channel_multipliers)
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        out_channels = cfg.input_channels * 2 if self._is_learned_sigma else cfg.output_channels
        dropout = float(cfg.get("dropout", 0.0))

        self._projections: Dict[str, nn.Module] = {}
        for name in cfg.conditioning.signals:
            self._add_projection(name, instantiate_from_config(
                cfg.conditioning.projections[name].to_dict()))
        head_cfg = cfg.conditioning.context_transformer_head
        head_list = head_cfg if isinstance(head_cfg, list) else [head_cfg.to_dict()]
        self._context_heads = [instantiate_from_config(h) for h in head_list]
        for i, head in enumerate(self._context_heads):
            if isinstance(head, nn.Module):
                self.add_module(f"_context_heads_{i}", head)
            if hasattr(head, "make_projection"):
                self._add_projection(head.projection_key, head.make_projection())
        # The blocks' `emb_proj` reads the timestep embedding at its width
        # (flax infers it from the input).
        emb_dim = next(self._projections[h.projection_key].out_features
                       for h in self._context_heads
                       if getattr(h, "output_context_key", None) == "timestep_embedding")
        self._class_conditional = bool(cfg.is_class_conditional)
        if self._class_conditional:
            self._label_projection = LabelEmbeddingProjection(cfg.num_classes, num_features * 4)

        s = cfg.input_spatial_size
        spatial = s if not isinstance(s, list) else s[0]
        attention_ds = [spatial // int(r) for r in cfg.attention.attention_resolutions]
        attn_base = instantiate_partial_from_config(
            cfg.conditioning.context_transformer_layer.to_dict())
        nblocks = cfg.num_resnet_blocks
        if not isinstance(nblocks, list):
            nblocks = [nblocks] * len(mults)

        def attention(ds):
            return (lambda ch: attn_base(in_channels=ch)) if ds in attention_ds else None

        self._downs: List[DBlock] = []
        ch, ds, skips = num_features, 1, []
        for level, mult in enumerate(mults):
            block = DBlock(ch, mult * num_features, emb_dim, nblocks[level], dropout,
                           attention(ds))
            self.add_module(f"down_{level}", block)
            self._downs.append(block)
            ch = mult * num_features
            skips.append(ch)
            if level != len(mults) - 1:
                ds *= 2
        skips.pop()  # the deepest block feeds the first U-block directly
        self._ups: List[UBlock] = []
        for level, mult in list(enumerate(mults))[::-1]:
            dim_in = ch + (skips.pop() if self._ups else 0)
            block = UBlock(dim_in, mult * num_features, emb_dim, nblocks[level] + 1, dropout,
                           attention(ds))
            self.add_module(f"up_{level}", block)
            self._ups.append(block)
            ch = mult * num_features
            ds //= 2
        self.initial_conv = ConvNHWC(cfg.input_channels, num_features, 3, padding=1,
                                     bias=False)
        self.final_norm = _gn(num_features * mults[0], silu=True)
        self.final_conv = ConvNHWC(num_features * mults[0], out_channels, 3, padding=1,
                                   bias=False)

    def _add_projection(self, name: str, module: nn.Module) -> None:
        self.add_module(f"_projections_{name}", module)
        self._projections[name] = module

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, output_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        if self._class_conditional and "classes" in context:
            context["class_embedding"] = self._label_projection(context["classes"])
        h = self.initial_conv(x)
        skips = []
        for block in self._downs:
            h = block(h, context)
            skips.append(h)
        skips.pop()
        for i, block in enumerate(self._ups):
            if i:
                h = torch.cat([h, skips.pop()], dim=-1)
            h = block(h, context)
        out = self.final_conv(self.final_norm(h)).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
