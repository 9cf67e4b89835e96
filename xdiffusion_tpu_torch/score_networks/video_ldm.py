"""Video-LDM: temporal adapters over an image UNet, NHWC frames.

Counterpart of xdiffusion_tpu/score_networks/video_ldm.py ("Align your
Latents"): the image UNet (score_networks/unet.py, built from the config's
`spatial_score_network`) runs per frame, frames folded into the batch and
the conditioning repeated over them; a `Conv3DLayer` follows every residual
block that does not resample and a `TemporalAttentionLayer` every spatial
attention, each mixed into the stream by a gate alpha clamped to [0, 1]
(initially 1: the image model). Both adapters are plain PyTorch, as the JAX
package computes them: shared-frame GroupNorm + SiLU, a 1-D convolution
over frames, and the frame attention with plain einsums.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import interleaved_frame_position_encoding
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.resnet import FastGroupNorm, num_groups_for
from xdiffusion_tpu_torch.score_networks.unet import Unet as ImageUnet
from xdiffusion_tpu_torch.score_networks.unet_3d import fold, tile_context_over_frames, unfold


def _gate(alpha: torch.Tensor, skip: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """alpha * skip + (1 - alpha) * out, alpha clamped to [0, 1]."""
    a = alpha.clamp(0.0, 1.0)
    return a * skip + (1.0 - a) * out


class Conv3DLayer(nn.Module):
    """Two [shared-frame GroupNorm -> SiLU -> Conv over frames, kernel 3]
    blocks (`block<i>_norm`, `block<i>_conv`), gated by `alpha`."""

    def __init__(self, channels: int, num_frames: int):
        super().__init__()
        self.num_frames = num_frames
        for i in (1, 2):
            self.add_module(f"block{i}_norm", FastGroupNorm(
                channels, num_groups_for(channels), silu=True, stat_frames=num_frames))
            self.add_module(f"block{i}_conv", nn.Conv1d(channels, channels, 3, padding=1))
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        f = self.num_frames
        b = bf // f
        h = x
        for i in (1, 2):
            h = getattr(self, f"block{i}_norm")(h)
            # Each position's frames as a (C, F) sequence for the 1-D conv.
            h = h.reshape(b, f, hh * ww, c).permute(0, 2, 3, 1).reshape(b * hh * ww, c, f)
            h = getattr(self, f"block{i}_conv")(h)
            h = h.reshape(b, hh * ww, c, f).permute(0, 3, 1, 2).reshape(bf, hh, ww, c)
        return _gate(self.alpha, x, h)


class TemporalAttentionLayer(nn.Module):
    """Attention over frames, gated by `alpha`: queries are each position's
    frames with the interleaved frame-position code added; keys and values
    are the example's text embeddings (the frame-repeated ones strided back
    by F) when the context holds them, else the queries' input."""

    def __init__(self, channels: int, num_frames: int, heads: int, kv_dim: int = -1):
        super().__init__()
        self.num_frames, self.heads = num_frames, heads
        proj = (channels // heads) * heads
        kv_in = kv_dim if kv_dim not in (None, -1) else channels
        self.q_proj = Dense(channels, proj, bias=False)
        self.k_proj = Dense(kv_in, proj, bias=False)
        self.v_proj = Dense(kv_in, proj, bias=False)
        self.o_proj = Dense(proj, channels, bias=False)
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        bf, hh, ww, c = x.shape
        f, heads = self.num_frames, self.heads
        b, hw, d = bf // f, hh * ww, c // self.heads
        q_in = x.reshape(b, f, hw, c).transpose(1, 2) + interleaved_frame_position_encoding(
            f, c, x.device)
        text = context.get("text_embeddings")
        kv = text[::f] if text is not None else q_in
        q = self.q_proj(q_in).reshape(b, hw, f, heads, d)
        k, v = self.k_proj(kv), self.v_proj(kv)
        if text is not None:  # (B, S, heads * d), shared by every position
            k, v = (t.reshape(b, -1, heads, d) for t in (k, v))
            logits = torch.einsum("bpthd,bshd->bphts", q, k) * d ** -0.5
            out = torch.einsum("bphts,bshd->bpthd", F.softmax(logits, dim=-1), v)
        else:
            k, v = (t.reshape(b, hw, f, heads, d) for t in (k, v))
            logits = torch.einsum("bpthd,bpshd->bphts", q, k) * d ** -0.5
            out = torch.einsum("bphts,bpshd->bpthd", F.softmax(logits, dim=-1), v)
        out = self.o_proj(out.reshape(b, hw, f, heads * d))
        return _gate(self.alpha, x, out.transpose(1, 2).reshape(bf, hh, ww, c))


class Unet(ImageUnet):
    """The image UNet with a `Conv3DLayer` after every non-resampling
    residual block (`temporal_<section>_<i>_conv<j>`) and a
    `TemporalAttentionLayer` after every attention
    (`temporal_<section>_<i>_attn`)."""

    def __init__(self, config: Any):
        super().__init__(config)
        frames = self._num_frames = int(config.input_number_of_frames)
        attn_params = self._net_config().conditioning.context_transformer_layer.get(
            "params", {})
        heads = int(attn_params.get("heads", 8))
        kv_dim = int(attn_params.get("context_dim", -1))
        self._temporal_place: Dict = {}
        for section, stages in (("downs", self._downs), ("middle", [self._middle]),
                                ("ups", self._ups)):
            for i, stage in enumerate(stages):
                slots, ch = {}, 0
                for idx, (kind, mod) in enumerate(stage):
                    if kind == "res" and not (mod.up or mod.down):
                        ch = mod.dim_out
                        name, layer = f"temporal_{section}_{i}_conv{idx}", Conv3DLayer(ch, frames)
                    elif kind == "attn":
                        name = f"temporal_{section}_{i}_attn"
                        layer = TemporalAttentionLayer(ch, frames, heads, kv_dim)
                    else:
                        continue
                    self.add_module(name, layer)
                    slots[idx] = layer
                if slots:
                    self._temporal_place[(section, i)] = slots

    def _net_config(self):
        return self.config.spatial_score_network

    def _post_element(self, h, stage_key, elem_idx, context):
        layer = self._temporal_place.get(stage_key, {}).get(elem_idx)
        if layer is None:
            return h
        if isinstance(layer, TemporalAttentionLayer):
            return layer(h, context)
        return layer(h)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C) -> (B, F, H, W, output_channels) fp32."""
        h, f = fold(x)
        out = unfold(self._backbone(h, tile_context_over_frames(self._conditioned(context), f)),
                     f)
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out


# The configs name the class VideoLDMUnet.
VideoLDMUnet = Unet
