"""Space-time factorized video UNet ("Video Diffusion Models"), NHWC frames.

Counterpart of xdiffusion_tpu/score_networks/unet_3d.py. A video (B, F, H,
W, C) folds its frames into the batch: the convolutions, residual blocks
(K4, with GroupNorm statistics shared over an example's frames) and spatial
attention (K1, K2 in its backward) run on (B*F, H, W, C) maps with the
per-example conditioning repeated over the frames; each attention
resolution adds a `TemporalSelfAttention` (`attn_t`) on the unfolded map.
The final norm is the shared-frame GroupNorm + SiLU, computed as its
coefficients, then the affine. Submodules carry the flax parameter paths'
names, as in the image UNet (score_networks/unet.py).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.config import instantiate_partial_from_config
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
from xdiffusion_tpu_torch.score_networks.unet import (
    build_stages,
    register_conditioning,
    register_stages,
)

# Per-example conditioning that repeats over the frames folded into the batch.
TILED_KEYS = ("timestep_embedding", "class_embedding", "context_embedding", "text_embeddings",
              "t5_text_embeddings", "clip_text_embeddings", "pooled_text_embeddings")


def fold(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B, F, H, W, C) -> ((B*F, H, W, C), F)."""
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c), f


def unfold(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B*F, H, W, C) -> (B, F, H, W, C)."""
    bf, h, w, c = x.shape
    return x.reshape(bf // f, f, h, w, c)


def tile_context_over_frames(context: Dict, f: int) -> Dict:
    """The context with each TILED_KEYS tensor repeated per frame."""
    out = dict(context)
    for key in TILED_KEYS:
        if key in out:
            out[key] = out[key].repeat_interleave(f, dim=0)
    return out


def register_label_projection(module: nn.Module, cfg) -> None:
    """A class-conditional network's `_label_projection`, the label table
    (with its NULL row) at the timestep embedding's width, num_features * 4."""
    if cfg.is_class_conditional:
        module._label_projection = LabelEmbeddingProjection(cfg.num_classes,
                                                            cfg.num_features * 4)


def stage_layout(cfg):
    """(channel multipliers, residual blocks per level, attention
    downsampling factors) of a video UNet's params block."""
    mults = list(cfg.channel_multipliers)
    nblocks = cfg.num_resnet_blocks
    if not isinstance(nblocks, list):
        nblocks = [nblocks] * len(mults)
    s = cfg.input_spatial_size
    width = s[1] if isinstance(s, list) else s
    return mults, nblocks, [width // int(r) for r in cfg.attention_resolutions]


class Unet(nn.Module):
    """Video UNet on (B, F, H, W, C); built from the params block as a
    DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = self.config = config
        num_features = cfg.num_features
        self._num_frames = frames = int(cfg.input_number_of_frames)
        dropout = float(cfg.dropout) if "dropout" in cfg else 0.0
        emb_dim = register_conditioning(self, cfg)
        register_label_projection(self, cfg)
        spatial_attn = instantiate_partial_from_config(
            cfg.conditioning.spatial_context_transformer_layer.to_dict())
        temporal_attn = instantiate_partial_from_config(
            cfg.conditioning.temporal_context_transformer_layer.to_dict())
        mults, nblocks, attention_ds = stage_layout(cfg)
        use_ss = bool(cfg.use_scale_shift_norm)
        resamp_conv = bool(cfg.resamp_with_conv)
        block_type = cfg.resnet_block_type if "resnet_block_type" in cfg else "biggan"
        # The video blocks condition through the Mlp stack, one layer unless set.
        mlp_layers = int(cfg.mlp_layers) if "mlp_layers" in cfg else 1

        def res_block(dim_in, dim_out, **kw):
            if block_type == "biggan":
                return ResnetBlockBigGAN(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                                         use_conv=resamp_conv, dropout=dropout,
                                         emb_mlp_layers=mlp_layers, stat_frames=frames, **kw)
            return ResnetBlockDDPM(dim_in, dim_out, emb_dim, use_scale_shift_norm=use_ss,
                                   dropout=dropout, emb_mlp_layers=mlp_layers,
                                   stat_frames=frames)

        def attn_pair(ch):
            return [("attn_s", spatial_attn(in_channels=ch)),
                    ("attn_t", temporal_attn(in_channels=ch))]

        def resample(kind, ch):
            return (Downsample if kind == "down" else Upsample)(ch, with_conv=resamp_conv)

        register_stages(self, *build_stages(num_features, mults, nblocks, attention_ds,
                                            res_block, attn_pair, resample,
                                            bool(cfg.resblock_updown)))
        self._build_ends(cfg, stat_frames=frames)

    def _build_ends(self, cfg, stat_frames: int) -> None:
        """initial_conv, final_norm (GroupNorm + SiLU) and final_conv."""
        nf = cfg.num_features
        self.initial_conv = ConvNHWC(cfg.input_channels, nf * cfg.channel_multipliers[0], 3,
                                     padding=1, bias=False)
        self.final_norm = FastGroupNorm(nf, num_groups_for(nf), silu=True,
                                        stat_frames=stat_frames)
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        self._output_channels = (cfg.input_channels * 2 if self._is_learned_sigma
                                 else cfg.output_channels)
        self.final_conv = ConvNHWC(nf, self._output_channels, 3, padding=1, bias=False)

    def _apply_stage(self, stage, h, f, folded_context, context, stage_id):
        for kind, mod in stage:
            if kind == "attn_t":
                h = fold(mod(unfold(h, f), context=context))[0]
            else:
                h = mod(h, context=folded_context)
        return self._post_stage(h, f, stage_id)

    def _post_stage(self, h, f, stage_id):
        """Runs after each stage; the identity."""
        return h

    def _initial(self, h):
        return self.initial_conv(h)

    def _final(self, h):
        return self.final_conv(self.final_norm(h))

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C) -> (B, F, H, W, output_channels) fp32, or the
        pair (prediction, log-variance) for a learned-sigma network."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        if self.config.is_class_conditional and "classes" in context:
            context["class_embedding"] = self._label_projection(context["classes"])
        h, f = fold(x)
        folded = tile_context_over_frames(context, f)
        h = self._initial(h)
        hs = [h]
        stage_id = 0
        for stage in self._downs:
            h = self._apply_stage(stage, h, f, folded, context, stage_id)
            hs.append(h)
            stage_id += 1
        h = self._apply_stage(self._middle, h, f, folded, context, stage_id)
        stage_id += 1
        for stage in self._ups:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_stage(stage, h, f, folded, context, stage_id)
            stage_id += 1
        out = unfold(self._final(h), f).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
