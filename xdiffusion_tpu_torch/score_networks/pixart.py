"""PixArt-alpha: the text-conditioned diffusion transformer with adaLN-single.

Counterpart of xdiffusion_tpu/score_networks/pixart.py ("PixArt-alpha: Fast
Training of Diffusion Transformer...", arXiv:2310.00426): patchify -> N
blocks of [self-attention, cross-attention to the caption, MLP], each
modulated by six signals that one shared timestep MLP (`t_block`) emits for
every block, plus a learned per-block offset table -> final adaLN layer ->
linear unpatchify.

Submodules carry the names of the JAX package's flax parameter paths
(`_blocks_{i}/cross_attn/{q,kv,proj}`, `_blocks_{i}/scale_shift_table`,
`t_block`, `final_scale_shift_table`, `final_norm`, `final_proj`,
`_projections_{signal}`, `_context_heads_{i}`), so the weight bridge
(weights.py) maps a flax tree onto this module mechanically. As in the JAX
package, the context heads that run a host-side projection (the prompt
tokenizer, which `preprocess_context` runs) are left out of the head list,
so a head's index is its index among the others.

Numerics as in the JAX package: every layer computes in fp32 (the JAX
module passes no dtype to its blocks); the norms are flax's affine-free
`nn.LayerNorm` (eps 1e-6), or DyT (layers/norm.py) with `norm_cls: dyt`;
the MLP's GELU is the tanh approximation; the cross-attention and final
projections are zero-initialised. Self-attention runs through K1 (its
gradient K2), cross-attention through `dot_product_attention` on (B, H, S,
D), so K5 (its gradient K6). The final layer's shift and scale are
`final_scale_shift_table` plus the raw timestep embedding, not `t_block`'s
output. Drop-path, in training mode, zeroes a residual branch per example
with the context's dropout generator. The JAX package's pipeline-parallel
block stack is a device-mesh feature: the port runs on one device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.config import instantiate_from_config
from xdiffusion_tpu_torch.layers.attention import MultiHeadSelfAttention
from xdiffusion_tpu_torch.layers.embedding import (
    PatchEmbed,
    RunProjection,
    sincos_position_embedding_2d,
)
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import DynamicTanhNorm
from xdiffusion_tpu_torch.layers.resnet import dropout_generator
from xdiffusion_tpu_torch.ops.attention import dot_product_attention
from xdiffusion_tpu_torch.score_networks.dit import _layer_norm
from xdiffusion_tpu_torch.utils import dropout_mask


class CrossAttention(nn.Module):
    """Tokens (B, N, C) attend to a conditioning sequence (B, L, C):
    bias-free `q` and `kv` (keys, then values), a biased zero-initialised
    `proj`."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.q = Dense(dim, dim, dtype=dtype, bias=False)
        self.kv = Dense(dim, 2 * dim, dtype=dtype, bias=False)
        self.proj = Dense(dim, dim, dtype=dtype, zero_init=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h, d = self.num_heads, c // self.num_heads
        k, v = self.kv(y).chunk(2, dim=-1)

        def heads(t):  # (B, S, C) -> a (B, H, S, D) view
            return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

        out = dot_product_attention(heads(self.q(x)), heads(k), heads(v))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


def _norm(norm_cls: str, dim: int):
    """DyT for `norm_cls: dyt`, else None: flax's affine-free LayerNorm,
    which holds no parameters."""
    return DynamicTanhNorm(dim) if norm_cls == "dyt" else None


def _apply_norm(norm: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    return _layer_norm(x) if norm is None else norm(x)


class PixArtBlock(nn.Module):
    """Self-attention, cross-attention (when there is a caption) and an MLP,
    modulated by the shared signals plus this block's `scale_shift_table`."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, norm_cls: str = "layer", cross_attention: bool = True):
        super().__init__()
        self.drop_path = drop_path
        self.scale_shift_table = nn.Parameter(torch.randn(6, hidden_size) / hidden_size ** 0.5)
        self.norm1 = _norm(norm_cls, hidden_size)
        self.attn = MultiHeadSelfAttention(hidden_size, num_heads)
        self.cross_attn = CrossAttention(hidden_size, num_heads) if cross_attention else None
        self.norm2 = _norm(norm_cls, hidden_size)
        mlp_dim = int(hidden_size * mlp_ratio)
        self.mlp_fc1 = Dense(hidden_size, mlp_dim)
        self.mlp_fc2 = Dense(mlp_dim, hidden_size)

    def _drop_path(self, h: torch.Tensor, context: Optional[Dict]) -> torch.Tensor:
        generator = dropout_generator(self, context)
        if generator is None or self.drop_path <= 0.0:
            return h
        keep = 1.0 - self.drop_path
        mask = dropout_mask((h.shape[0], 1, 1), keep, generator, h.device)
        return h * mask / keep

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor], shared_mod: torch.Tensor,
                context: Optional[Dict] = None) -> torch.Tensor:
        mod = shared_mod + self.scale_shift_table[None]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.unbind(dim=1)
        h = _apply_norm(self.norm1, x) * (1.0 + scale_msa[:, None]) + shift_msa[:, None]
        h = self.attn(h, context)
        x = x + self._drop_path(gate_msa[:, None] * h, context)
        if y is not None:
            x = x + self.cross_attn(x, y)
        h = _apply_norm(self.norm2, x) * (1.0 + scale_mlp[:, None]) + shift_mlp[:, None]
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + self._drop_path(gate_mlp[:, None] * h, context)


class PixArtAlpha(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    # The DyT variant (score_networks/dyt.py) flips this; `norm_cls:` in the
    # config wins.
    _default_norm_cls = "layer"

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._patch_size = int(cfg.patch_size)
        hidden = int(cfg.hidden_size)
        self._hidden = hidden
        self._is_learned_sigma = bool(cfg.is_learned_sigma)
        self._out_channels = (cfg.input_channels * 2 if self._is_learned_sigma
                              else cfg.output_channels)
        s = cfg.input_spatial_size
        self._spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        self._context_key = cfg.get("context_key", "context_embeddings")

        # Host-side projections (the prompt tokenizer) are not part of the
        # module; `preprocess_context` runs them.
        self._projections: Dict[str, nn.Module] = {}
        host_keys = []
        for name in cfg.conditioning.signals:
            proj = instantiate_from_config(cfg.conditioning.projections[name].to_dict())
            if getattr(proj, "host_side", False):
                host_keys.append(name)
                continue
            self.add_module(f"_projections_{name}", proj)
            self._projections[name] = proj
        head_cfg = cfg.conditioning.context_transformer_head
        head_list = head_cfg if isinstance(head_cfg, list) else [head_cfg.to_dict()]
        self._context_heads = []
        for h in head_list:
            head = instantiate_from_config(h)
            if isinstance(head, RunProjection) and head.projection_key in host_keys:
                continue
            if isinstance(head, nn.Module):
                self.add_module(f"_context_heads_{len(self._context_heads)}", head)
            self._context_heads.append(head)

        self.patch_embed = PatchEmbed(cfg.input_channels, self._patch_size, hidden)
        grid = [self._spatial[0] // self._patch_size, self._spatial[1] // self._patch_size]
        self.register_buffer(
            "_pos_embed",
            sincos_position_embedding_2d(hidden, grid[0], grid[1], base_size=grid[0],
                                         lewei_scale=float(cfg.get("lewei_scale", 1.0))),
            persistent=False)
        # adaLN-single: one MLP emits the six modulation signals of every block.
        self.t_block = Dense(hidden, 6 * hidden)
        norm_cls = cfg.get("norm_cls", self._default_norm_cls)
        self._blocks = []
        for i in range(int(cfg.depth)):
            block = PixArtBlock(hidden, int(cfg.num_heads), mlp_ratio=float(cfg.mlp_ratio),
                                drop_path=float(cfg.get("drop_path", 0.0)), norm_cls=norm_cls,
                                cross_attention=bool(self._context_key))
            self.add_module(f"_blocks_{i}", block)
            self._blocks.append(block)
        self.final_scale_shift_table = nn.Parameter(torch.randn(2, hidden) / hidden ** 0.5)
        self.final_norm = _norm(norm_cls, hidden)
        self.final_proj = Dense(hidden, self._patch_size ** 2 * self._out_channels,
                                zero_init=True)

    def _unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, p*p*C) -> (B, H, W, C)."""
        b = x.shape[0]
        p = self._patch_size
        gh, gw = self._spatial[0] // p, self._spatial[1] // p
        x = x.reshape(b, gh, gw, p, p, self._out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * p, gw * p, self._out_channels)

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, H, W, C) -> (B, H, W, output_channels) fp32, or the pair
        (prediction, log-variance) of a learned-sigma network."""
        context = dict(context)
        for head in self._context_heads:
            context = head(context, self._projections)
        t_emb = context["timestep_embedding"]
        shared_mod = self.t_block(F.silu(t_emb)).reshape(t_emb.shape[0], 6, self._hidden)
        # The caption's (B, L, hidden) sequence, or None for a config without
        # one (context_key: null).
        y = context[self._context_key] if self._context_key else None
        tokens = self.patch_embed(x) + self._pos_embed[None]
        for block in self._blocks:
            tokens = block(tokens, y, shared_mod, context)
        fmod = self.final_scale_shift_table[None] + t_emb[:, None]
        shift, scale = fmod[:, 0], fmod[:, 1]
        tokens = _apply_norm(self.final_norm, tokens) * (1.0 + scale[:, None]) + shift[:, None]
        out = self._unpatchify(self.final_proj(tokens)).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out

    def _pipelined_blocks(self, *args, **kwargs):
        """The JAX package's GPipe stack over a 'pipeline' mesh axis."""
        raise NotImplementedError(
            "the pipeline-parallel PixArt block stack is not ported yet "
            "(ROADMAP.md queue 1, item 14: multi-GPU)")
