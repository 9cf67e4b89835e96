"""AnimateDiff: motion modules on an image UNet, NHWC frames.

Counterpart of xdiffusion_tpu/score_networks/animate_diff.py: the image
UNet (score_networks/unet.py, built from the config's
`spatial_score_network`) runs per frame, frames folded into the batch and
the conditioning repeated over them, and a motion module
(`TemporalTransformer`) follows each stage's attention, or its first
residual block when it has none, never a resampling stage. A motion module:
shared-frame GroupNorm (eps 1e-6, no SiLU) -> proj_in -> blocks of
[LayerNorm -> gated frame self-attention] and a GEGLU feed-forward ->
zero-initialised proj_out -> residual. The frame attention goes to K5
(`dot_product_attention`) on (B*H*W, heads, F, head_dim), its gradient to K6.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import interleaved_frame_position_encoding
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.unet import Unet as ImageUnet
from xdiffusion_tpu_torch.score_networks.unet_3d import fold, tile_context_over_frames, unfold
from xdiffusion_tpu_torch.score_networks.video_ldm import _gate


class MotionSelfAttention(nn.Module):
    """Frame self-attention of (B, HW, T, C), gated by `alpha`: the frame
    code added, bias-free q/k/v/o projections, K5 over each position's T
    frames."""

    def __init__(self, channels: int, num_frames: int, heads: int):
        super().__init__()
        self.num_frames, self.heads = num_frames, heads
        proj = (channels // heads) * heads
        self.q_proj = Dense(channels, proj, bias=False)
        self.k_proj = Dense(channels, proj, bias=False)
        self.v_proj = Dense(channels, proj, bias=False)
        self.o_proj = Dense(proj, channels, bias=False)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hw, t, c = x.shape
        h = x + interleaved_frame_position_encoding(self.num_frames, c, x.device)
        q, k, v = (p(h).reshape(b * hw, t, self.heads, c // self.heads).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention(q, k, v).transpose(1, 2).reshape(b, hw, t, -1)
        return _gate(self.alpha, x, self.o_proj(out))


class TemporalTransformerBlock(nn.Module):
    """`norm_<a>` -> `attn_<a>` residual sub-blocks, then the GEGLU
    feed-forward (`ff_norm`, `ff_in` to 2 x 4 x dim, value * gelu(gate),
    `ff_out`) as a residual."""

    def __init__(self, dim: int, num_frames: int, heads: int, num_attention_blocks: int):
        super().__init__()
        self.blocks = num_attention_blocks
        for a in range(num_attention_blocks):
            self.add_module(f"norm_{a}", LayerNorm(dim))
            self.add_module(f"attn_{a}", MotionSelfAttention(dim, num_frames, heads))
        self.ff_norm = LayerNorm(dim)
        self.ff_in = Dense(dim, 8 * dim)
        self.ff_out = Dense(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for a in range(self.blocks):
            x = getattr(self, f"attn_{a}")(getattr(self, f"norm_{a}")(x)) + x
        val, gate = self.ff_in(self.ff_norm(x)).chunk(2, dim=-1)
        return self.ff_out(val * F.gelu(gate)) + x


class TemporalTransformer(nn.Module):
    """One motion module on frame-folded (B*F, H, W, C) maps."""

    def __init__(self, channels: int, num_frames: int, heads: int, head_dim: int,
                 blocks_per_layer: int, num_layers: int = 1):
        super().__init__()
        self.num_frames, self.num_layers = num_frames, num_layers
        inner = heads * head_dim
        self.norm = FastGroupNorm(channels, num_groups_for(channels), epsilon=1e-6,
                                  stat_frames=num_frames)
        self.proj_in = Dense(channels, inner)
        for layer in range(num_layers):
            self.add_module(f"block_{layer}", TemporalTransformerBlock(
                inner, num_frames, heads, blocks_per_layer))
        self.proj_out = Dense(inner, channels, zero_init=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        f = self.num_frames
        h = self.proj_in(self.norm(x).reshape(bf // f, f, hh * ww, c).transpose(1, 2))
        for layer in range(self.num_layers):
            h = getattr(self, f"block_{layer}")(h)
        return self.proj_out(h).transpose(1, 2).reshape(bf, hh, ww, c) + x


def _res_stage_plan(stage) -> int:
    """The element after which a stage's motion module runs: its attention,
    else its first residual block; -1 (none) for a resampling stage."""
    kinds = [kind for kind, _ in stage]
    if "attn" in kinds:
        return kinds.index("attn")
    if kinds and kinds[0] == "res":
        mod = stage[0][1]
        return -1 if kinds == ["res"] and (mod.up or mod.down) else 0
    return -1


class Unet(ImageUnet):
    """The image UNet with motion modules (`motion_down_<i>`,
    `motion_middle`, `motion_up_<i>`)."""

    def __init__(self, config: Any):
        super().__init__(config)
        mm = config.motion_module
        frames = self._num_frames = int(config.input_number_of_frames)

        def make(stage):
            return TemporalTransformer(stage[0][1].dim_out, frames,
                                       int(mm.num_attention_heads), int(mm.attention_head_dims),
                                       int(mm.num_attention_blocks_per_layer),
                                       int(mm.get("num_layers", 1)))

        self._motion_place: Dict = {}
        for section, name, stages in (("downs", "motion_down", self._downs),
                                      ("ups", "motion_up", self._ups)):
            for i, stage in enumerate(stages):
                place = _res_stage_plan(stage)
                if place >= 0:
                    module = make(stage)
                    self.add_module(f"{name}_{i}", module)
                    self._motion_place[(section, i)] = (place, module)
        self.motion_middle = make(self._middle)
        kinds = [kind for kind, _ in self._middle]
        self._motion_place[("middle", 0)] = (kinds.index("attn"), self.motion_middle)

    def _net_config(self):
        return self.config.spatial_score_network

    def _post_element(self, h, stage_key, elem_idx, context):
        place, module = self._motion_place.get(stage_key, (-1, None))
        return module(h) if place == elem_idx else h

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C) -> (B, F, H, W, output_channels) fp32."""
        h, f = fold(x)
        out = unfold(self._backbone(h, tile_context_over_frames(self._conditioned(context), f)),
                     f)
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out


# The configs name the class AnimateDiffUnet.
AnimateDiffUnet = Unet
