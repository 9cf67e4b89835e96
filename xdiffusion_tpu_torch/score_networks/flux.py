"""Flux: the rectified-flow transformer with double- and single-stream blocks.

Counterpart of `Flux` in xdiffusion_tpu/score_networks/flux.py: patchified
image tokens and the T5 text sequence run through `depth` double-stream
blocks, merge as [text; image], then run through `depth_single_blocks`
single-stream blocks; the conditioning vector is the time embedding plus
the CLIP pooled embedding's (plus, with `guidance_embed`, the distilled
guidance scale's); 3-axis RoPE over (0, row, col) image ids and all-zero
text ids. The time features are the cos-first GLIDE sinusoid of 1000 * t.

The text arrives host-side: context["t5_text_embeddings"] (B, L,
context_in_dim) and context["clip_text_embeddings"] (B, vec_in_dim), from
the offline T5 and CLIP embedders (layers/embedding.py).

Submodules carry the names of the JAX package's flax parameter paths
(`img_in`, `time_in`, `vector_in`, `guidance_in`, `txt_in`, `double_{i}`,
`single_{i}`, `final`). Each attention (one a block) runs on K5 on the
card, its gradient on K6. The JAX package's pipeline-parallel block stacks
(a device-mesh feature) are not ported: the port runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.flux import (
    DoubleStreamBlock,
    LastLayer,
    MLPEmbedder,
    SingleStreamBlock,
    rope_frequencies,
)
from xdiffusion_tpu_torch.layers.linear import Dense


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)(W/p), C*p*p), channel-first patch features."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpatchify(x: torch.Tensor, b: int, h: int, w: int, c: int, p: int) -> torch.Tensor:
    """`patchify`'s inverse, as fp32 (B, H, W, C)."""
    x = x.reshape(b, h // p, w // p, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, c).float()


def image_ids(b: int, gh: int, gw: int, device) -> torch.Tensor:
    """(B, gh*gw, 3) fp32 ids (0, row, col), row-major."""
    rows = torch.arange(gh, device=device).repeat_interleave(gw)
    cols = torch.arange(gw, device=device).repeat(gh)
    ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1).float()
    return ids[None].expand(b, gh * gw, 3)


class FluxSkeleton(nn.Module):
    """What Flux and Chewie share: the input projections, the conditioning
    vector, the RoPE tables, the single-stream stack and the last layer.
    A subclass builds `double_{i}`. With `guidance_embed`, `guidance_in`
    embeds context["distillation_guidance"] into the vector too."""

    _norm_cls = "layernorm"

    def __init__(self, config: Any, guidance_embed: bool = False):
        super().__init__()
        cfg = config
        self._patch_size = int(cfg.patch_size)
        d = int(cfg.hidden_size)
        self._num_heads = int(cfg.num_heads)
        self._axes_dim = tuple(cfg.axes_dim)
        if sum(self._axes_dim) != d // self._num_heads:
            raise ValueError(f"axes_dim {self._axes_dim} must sum to head dim "
                             f"{d // self._num_heads}")
        self._theta = float(cfg.get("theta", 10000))
        in_channels = int(cfg.in_channels)
        self.img_in = Dense(in_channels, d)
        self.time_in = MLPEmbedder(256, d)
        self.guidance_in = MLPEmbedder(256, d) if guidance_embed else None
        self.vector_in = MLPEmbedder(int(cfg.vec_in_dim), d)
        self.txt_in = Dense(int(cfg.context_in_dim), d)
        self._double_blocks = []
        self._single_blocks = []
        for i in range(int(cfg.depth_single_blocks)):
            block = SingleStreamBlock(d, self._num_heads, mlp_ratio=float(cfg.mlp_ratio),
                                      norm_cls=self._norm_cls)
            self.add_module(f"single_{i}", block)
            self._single_blocks.append(block)
        self.final = LastLayer(d, in_channels, norm_cls=self._norm_cls)

    def _add_double(self, i: int, block: nn.Module) -> None:
        self.add_module(f"double_{i}", block)
        self._double_blocks.append(block)

    def _vec(self, context: Dict) -> torch.Tensor:
        t = context["timestep"].float()
        vec = self.time_in(glide_timestep_embedding(t, 256, scale=1000.0))
        if self.guidance_in is not None:
            g = context["distillation_guidance"].float()
            vec = vec + self.guidance_in(glide_timestep_embedding(g, 256, scale=1000.0))
        return vec + self.vector_in(context["clip_text_embeddings"])

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        """x: (B, H, W, C) -> the fp32 velocity (B, H, W, C)."""
        b, h, w, c = x.shape
        p = self._patch_size
        img = self.img_in(patchify(x, p))
        txt = self.txt_in(context["t5_text_embeddings"])
        vec = self._vec(context)
        ids = torch.cat([torch.zeros((b, txt.shape[1], 3), device=x.device),
                         image_ids(b, h // p, w // p, x.device)], dim=1)
        cos, sin = rope_frequencies(ids, self._axes_dim, self._theta)
        for block in self._double_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        merged = torch.cat([txt, img], dim=1)
        for block in self._single_blocks:
            merged = block(merged, vec, cos, sin)
        img = self.final(merged[:, txt.shape[1]:], vec)
        return unpatchify(img, b, h, w, c, p)


class Flux(FluxSkeleton):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__(config, guidance_embed=bool(config.get("guidance_embed", False)))
        for i in range(int(config.depth)):
            self._add_double(i, DoubleStreamBlock(
                int(config.hidden_size), self._num_heads, mlp_ratio=float(config.mlp_ratio),
                qkv_bias=bool(config.get("qkv_bias", True)), norm_cls=self._norm_cls))
