"""WideFormer: a wide (not deep) Flux-style rectified-flow transformer.

Counterpart of `WideFormerSingleBlock` and `WideFormer` in
xdiffusion_tpu/score_networks/wideformer.py. Each of `depth` layers runs
`transformer_width` parallel double-stream blocks (layers/flux.py) over the
image tokens; their outputs are joined feature-wise and re-viewed as a
(width * L)-token sequence, which each block of the next layer (and the
final block) first mixes back to L tokens with a 3-tap convolution whose
channels are the tokens (`token_mixer`: flax's Conv over (B, D, L_in),
kernel (3, L_in, L_out), padding SAME, is `nn.Conv1d(L_in, L_out, 3,
padding=1)` on (B, L_in, D), weight (L_out, L_in, 3)). The conditioning is
Flux's: the T5 sequence context["t5_text_embeddings"] through `txt_in`, the
pooled CLIP vector context["clip_text_embeddings"] and the time (the
cos-first GLIDE sinusoid of 1000 * t) into the modulation vector, 3-axis
RoPE over (0, row, col) image ids and all-zero text ids.

Submodules carry the flax names (`img_in`, `time_in`, `vector_in`,
`txt_in`, `layer<i>_block<w>/token_mixer`, `layer<i>_block<w>/block`,
`final_block`, `final`). Each block's attention runs on K5 on the card (its
gradient on K6): depth * width + 1 calls a forward.
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
    rope_frequencies,
)
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.score_networks.flux import image_ids, patchify, unpatchify


class WideFormerSingleBlock(nn.Module):
    """The token mixer (when the incoming sequence is longer than L) and one
    double-stream block; returns the block's (image, text) streams."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, in_tokens: int,
                 out_tokens: int):
        super().__init__()
        self.token_mixer = (nn.Conv1d(in_tokens, out_tokens, 3, padding=1)
                            if in_tokens != out_tokens else None)
        if self.token_mixer is not None:
            nn.init.zeros_(self.token_mixer.bias)
        self.block = DoubleStreamBlock(hidden_size, num_heads, mlp_ratio=mlp_ratio, qkv_bias=True)

    def forward(self, img, txt, vec, cos, sin):
        if self.token_mixer is not None:
            img = self.token_mixer(img)  # (B, L_in, D) -> (B, L_out, D)
        return self.block(img, txt, vec, cos, sin)


class WideFormer(nn.Module):
    """Built from the score_network params block as a DotConfig: patch_size,
    in_channels (C * patch^2), hidden_size, num_heads, axes_dim, theta,
    vec_in_dim, context_in_dim, input_spatial_size, mlp_ratio,
    transformer_width, depth (max_text_tokens and guidance_embed are taken
    and unused, as in the JAX package)."""

    def __init__(self, config: Any):
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
        self._width = int(cfg.transformer_width)
        mlp_ratio = float(cfg.mlp_ratio)
        tokens = (int(cfg.input_spatial_size) // self._patch_size) ** 2

        self.img_in = Dense(in_channels, d)
        self.time_in = MLPEmbedder(256, d)
        self.vector_in = MLPEmbedder(int(cfg.vec_in_dim), d)
        self.txt_in = Dense(int(cfg.context_in_dim), d)
        self._layers = []
        for i in range(int(cfg.depth)):
            layer = []
            for w in range(self._width):
                block = WideFormerSingleBlock(d, self._num_heads, mlp_ratio,
                                              tokens if i == 0 else tokens * self._width, tokens)
                self.add_module(f"layer{i}_block{w}", block)
                layer.append(block)
            self._layers.append(layer)
        self.final_block = WideFormerSingleBlock(d, self._num_heads, mlp_ratio,
                                                 tokens * self._width, tokens)
        self.final = LastLayer(d, in_channels)

    def forward(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        """x: (B, H, W, C) -> the fp32 velocity (B, H, W, C)."""
        b, h, w, c = x.shape
        p = self._patch_size
        img = self.img_in(patchify(x, p))
        txt = self.txt_in(context["t5_text_embeddings"])
        t = context["timestep"].float()
        vec = self.time_in(glide_timestep_embedding(t, 256, scale=1000.0))
        vec = vec + self.vector_in(context["clip_text_embeddings"])
        ids = torch.cat([torch.zeros((b, txt.shape[1], 3), device=x.device),
                         image_ids(b, h // p, w // p, x.device)], dim=1)
        cos, sin = rope_frequencies(ids, self._axes_dim, self._theta)
        n, d = img.shape[1], img.shape[2]

        layer_input = img
        for layer in self._layers:
            outputs = [block(layer_input, txt, vec, cos, sin)[0] for block in layer]
            # (B, L, width * D) -> (B, width * L, D): the reference's
            # cat(dim=2).view interleaving.
            layer_input = torch.cat(outputs, dim=2).reshape(b, n * self._width, d)
        img, _ = self.final_block(layer_input, txt, vec, cos, sin)
        return unpatchify(self.final(img, vec), b, h, w, c, p)
