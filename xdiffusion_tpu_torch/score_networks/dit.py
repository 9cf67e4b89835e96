"""DiT: the Diffusion Transformer score network with adaLN-Zero conditioning.

Counterpart of xdiffusion_tpu/score_networks/dit.py ("Scalable Diffusion
Models with Transformers", arXiv:2212.09748): patchify -> transformer
blocks modulated by the timestep (+ class) embedding -> linear unpatchify
head. A block with `num_experts` > 1 replaces its dense MLP with a
Switch-routed expert bank (layers/moe.py).

Submodules carry the names of the JAX package's flax parameter paths
(`_blocks_{i}`, `patch_embed`, `_final`, `_projections_{signal}`), so the
weight bridge (weights.py) maps a flax tree onto this module mechanically.

Numerics as in the JAX package:

- the norms are flax's affine-free `nn.LayerNorm`: eps 1e-6, statistics in
  fp32, the result in the input's dtype;
- the GELU is the tanh approximation;
- the adaLN modulations and the final projection are zero-initialised, so
  a freshly built network outputs zeros;
- with `dtype: bfloat16` the patch embedding and the blocks' Dense layers
  compute in bf16, while the residual stream stays fp32 (the fp32 position
  table promotes it) and `FinalLayer` is built without the network's dtype
  and computes in fp32; the output is fp32.

Training mode and `context["dropout_generator"]` drive dropout, as in the
UNet (score_networks/unet.py). The JAX package's pipeline-parallel block
stack (`_pipelined_blocks`, a device-mesh feature) is not ported: the port
runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.config import instantiate_from_config
from xdiffusion_tpu_torch.layers.attention import MultiHeadSelfAttention
from xdiffusion_tpu_torch.layers.embedding import PatchEmbed, sincos_position_embedding_2d
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.moe import MoEMlp
from xdiffusion_tpu_torch.layers.resnet import dropout_generator
from xdiffusion_tpu_torch.score_networks.unet import DTYPES
from xdiffusion_tpu_torch.utils import dropout


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.LayerNorm(use_bias=False, use_scale=False)`."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(x.dtype)


class DiTBlock(nn.Module):
    """Self-attention and an MLP (or an expert bank), each modulated by the
    six adaLN signals of the conditioning vector."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 num_experts: int = 0, moe_top_k: int = 1, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dropout = dropout
        self.adaLN_modulation = Dense(hidden_size, 6 * hidden_size, dtype=dtype,
                                      zero_init=True)
        self.attn = MultiHeadSelfAttention(hidden_size, num_heads, dropout=dropout,
                                           dtype=dtype)
        mlp_dim = int(hidden_size * mlp_ratio)
        self.moe = num_experts > 1
        if self.moe:
            self.moe_mlp = MoEMlp(hidden_size, mlp_dim, num_experts, top_k=moe_top_k,
                                  capacity_factor=moe_capacity_factor, dropout=dropout,
                                  dtype=dtype)
        else:
            self.mlp_fc1 = Dense(hidden_size, mlp_dim, dtype=dtype)
            self.mlp_fc2 = Dense(mlp_dim, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                context: Optional[Dict] = None) -> torch.Tensor:
        mod = self.adaLN_modulation(F.silu(c))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        attn = self.attn(modulate(_layer_norm(x), shift_msa, scale_msa), context)
        x = x + gate_msa[:, None, :] * attn
        h = modulate(_layer_norm(x), shift_mlp, scale_mlp)
        if self.moe:
            h = self.moe_mlp(h, context)
        else:
            h = F.gelu(self.mlp_fc1(h), approximate="tanh")
            generator = dropout_generator(self, context)
            if generator is not None:
                h = dropout(h, self.dropout, generator)
            h = self.mlp_fc2(h)
        return x + gate_mlp[:, None, :] * h


class FinalLayer(nn.Module):
    """adaLN shift and scale, then the zero-initialised projection to
    p * p * out_channels, in fp32."""

    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.adaLN_modulation = Dense(hidden_size, 2 * hidden_size, zero_init=True)
        self.proj = Dense(hidden_size, patch_size * patch_size * out_channels,
                          zero_init=True)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(F.silu(c)).chunk(2, dim=-1)
        return self.proj(modulate(_layer_norm(x), shift, scale))


class DiT(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        dt = DTYPES[cfg.get("dtype", "float32")]
        self.compute_dtype = dt
        self._patch_size = int(cfg.patch_size)
        hidden = int(cfg.hidden_size)
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        self._out_channels = (cfg.input_channels * 2 if self._is_learned_sigma
                              else cfg.output_channels)
        s = cfg.input_spatial_size
        self._spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]

        self._projections: Dict[str, nn.Module] = {}
        for name in cfg.conditioning.signals:
            proj = instantiate_from_config(cfg.conditioning.projections[name].to_dict())
            self.add_module(f"_projections_{name}", proj)
            self._projections[name] = proj
        head_cfg = cfg.conditioning.context_transformer_head
        head_list = head_cfg if isinstance(head_cfg, list) else [head_cfg.to_dict()]
        self._context_heads = [instantiate_from_config(h) for h in head_list]

        self.patch_embed = PatchEmbed(cfg.input_channels, self._patch_size, hidden, dtype=dt)
        grid = [self._spatial[0] // self._patch_size, self._spatial[1] // self._patch_size]
        # base_size=16: the reference DiT's default, which rescales the
        # positions by 16 / grid.
        self.register_buffer(
            "_pos_embed", sincos_position_embedding_2d(hidden, grid[0], grid[1], base_size=16),
            persistent=False)
        dropout_rate = float(cfg.dropout) if "dropout" in cfg else 0.0
        self._blocks = []
        for i in range(int(cfg.depth)):
            block = DiTBlock(hidden, int(cfg.num_heads), mlp_ratio=float(cfg.mlp_ratio),
                             dropout=dropout_rate, dtype=dt,
                             num_experts=int(cfg.get("num_experts", 0) or 0),
                             moe_top_k=int(cfg.get("moe_top_k", 1) or 1),
                             moe_capacity_factor=float(cfg.get("moe_capacity_factor", 1.25)))
            self.add_module(f"_blocks_{i}", block)
            self._blocks.append(block)
        self._final = FinalLayer(hidden, self._patch_size, self._out_channels)

    def _unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, p*p*C) -> (B, H, W, C)."""
        b = x.shape[0]
        p = self._patch_size
        gh, gw = self._spatial[0] // p, self._spatial[1] // p
        x = x.reshape(b, gh, gw, p, p, self._out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, self._out_channels)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, output_channels) fp32, or the two
        halves (prediction, variance) of a learned-sigma network."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        c = context["timestep_embedding"]
        tokens = self.patch_embed(x) + self._pos_embed[None]
        for block in self._blocks:
            tokens = block(tokens, c, context)
        out = self._unpatchify(self._final(tokens, c)).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
