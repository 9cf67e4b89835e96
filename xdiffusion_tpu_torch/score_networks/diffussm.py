"""DiffuSSM: attention-free diffusion with bidirectional state spaces.

Counterpart of `DiffusionSSMBlock` and `DiffusionSSM` in
xdiffusion_tpu/score_networks/diffussm.py ("Diffusion Models Without
Attention", arXiv:2311.18257): one token per pixel runs through N blocks of
[adaLN modulation -> hourglass (sequence down, MLP, up) -> bidirectional
S4D -> gated fusion]. No attention: dense products and FFT convolutions
(layers/s4d.py), so no kernel of the port runs here.

The JAX package's quirks, kept:
- the block's residual adds the gated fusion to the MODULATED input h, not
  to x;
- class labels are never read, though the config is class-conditional;
- the time features are the cos-first GLIDE sinusoid of the step.

Submodules carry the names of the JAX package's flax parameter paths
(`input_proj`, `layer_{i}`, `output_proj`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.flux import MLPEmbedder
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.s4d import SequenceResidualBlock
from xdiffusion_tpu_torch.score_networks.dit import _layer_norm as layer_norm


class DiffusionSSMBlock(nn.Module):
    """One DiffuSSM block on (B, L, d) tokens under a (B, 256) condition."""

    def __init__(self, d_model: int, seq_len: int, hourglass_ratio: int = 2,
                 bidirectional: bool = True, cond_dim: int = 256):
        super().__init__()
        d, length = d_model, seq_len
        j = length // hourglass_ratio
        self.condition_embedder = MLPEmbedder(cond_dim, d)
        self.modulation = Dense(d, 3 * d)
        self.hourglass_down = Dense(length, j)
        self.hourglass_mlp = MLPEmbedder(d, d)
        self.hourglass_up = Dense(j, length)
        self.ssm = SequenceResidualBlock(d, bidirectional=bidirectional)
        self.down_left = Dense(length, j)
        self.mlp_left = MLPEmbedder(d, d)
        self.down_right = Dense(length, j)
        self.mlp_right = MLPEmbedder(d, d)
        self.mlp_final = MLPEmbedder(d, d)
        self.upscale_final = Dense(j, length)

    @staticmethod
    def _resample(proj: Dense, t: torch.Tensor) -> torch.Tensor:
        """A Dense over the SEQUENCE axis (the reference's k=1 Conv1d with
        positions as channels): (B, L, d) -> (B, L', d)."""
        return proj(t.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.modulation(F.silu(self.condition_embedder(cond))).chunk(3, -1)
        h = (1.0 + scale[:, None]) * layer_norm(x) + shift[:, None]
        hg = self._resample(self.hourglass_down, h)
        hg = self._resample(self.hourglass_up, self.hourglass_mlp(hg))
        h_ssm, _ = self.ssm(hg)
        left = self.mlp_left(self._resample(self.down_left, h))
        right = self.mlp_right(self._resample(self.down_right, h_ssm))
        fused = self._resample(self.upscale_final, self.mlp_final(left * right))
        return h + gate[:, None] * fused


class DiffusionSSM(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        d = int(cfg.d_model)
        seq_len = int(cfg.input_spatial_size) ** 2
        self._is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        self._d_out = (int(cfg.get("output_channels", cfg.d_input))
                       * (2 if self._is_learned_sigma else 1))
        self.input_proj = Dense(int(cfg.input_channels), d)
        self.output_proj = Dense(d, self._d_out)
        bidirectional = True
        if "block_config" in cfg and "params" in cfg.block_config:
            bidirectional = bool(cfg.block_config.params.get("bidirectional", True))
        self._blocks = []
        for i in range(int(cfg.n_layers)):
            block = DiffusionSSMBlock(d, seq_len, hourglass_ratio=int(cfg.get("M", 2)),
                                      bidirectional=bidirectional)
            self.add_module(f"layer_{i}", block)
            self._blocks.append(block)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, output_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        b, h, w, c = x.shape
        cond = glide_timestep_embedding(context["timestep"].float(), 256)
        tokens = self.input_proj(x.reshape(b, h * w, c))
        for block in self._blocks:
            tokens = block(tokens, cond)
        out = self.output_proj(tokens).reshape(b, h, w, self._d_out).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
