"""Token-sequence transformer and the GLIDE text-conditioning head.

Counterpart of `TransformerBlock`, `Transformer` and
`GLIDETransformerWrapper` in xdiffusion_tpu/layers/transformer.py: a small
pre-LN transformer encodes the embedded text tokens once at the top of the
score network; its last token, projected, is added to the timestep
embedding, and the whole sequence becomes context["context_embedding"] for
the cross-attention layers. Its attention is `MultiHeadSelfAttention`,
through K1 (and K2 in training).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.attention import MultiHeadSelfAttention
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm


class TransformerBlock(nn.Module):
    """x + attn(ln1(x)), then + fc2(gelu_tanh(fc1(ln2(x)))); the norms in
    fp32, as flax's `nn.LayerNorm` with no dtype."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(width)
        self.attn = MultiHeadSelfAttention(width, heads, dtype=dtype)
        self.ln2 = LayerNorm(width)
        self.fc1 = Dense(width, 4 * width, dtype=dtype)
        self.fc2 = Dense(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class GLIDETransformerWrapper(nn.Module):
    """Context head, called with (context, projections): embeds
    context["text_tokens"] with projections["text_tokens"] (or takes one
    context["text_embedding"] vector as a one-token sequence), adds the
    learned width vector `positional_embedding` to every position, runs the
    transformer (and `final_ln`), adds proj(last token) to
    context["timestep_embedding"] and writes the sequence to
    context["context_embedding"]."""

    def __init__(self, context_dim: int, width: int, layers: int, heads: int,
                 final_layer_norm: bool = True, output_projection_dimension: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(1, 1, width) * 0.01)
        self.transformer = Transformer(width, layers, heads, dtype)
        self.final_ln = LayerNorm(width) if final_layer_norm else None
        self.proj = Dense(width, output_projection_dimension, dtype=dtype)

    def forward(self, context: Dict, projections: Dict) -> Dict:
        if "text_embedding" in context:
            xf_in = context["text_embedding"][:, None, :]
        elif "text_tokens" in context:
            xf_in = projections["text_tokens"](context["text_tokens"])
        else:
            raise KeyError("GLIDE transformer needs text tokens or embeddings.")
        xf_out = self.transformer(xf_in + self.positional_embedding)
        if self.final_ln is not None:
            xf_out = self.final_ln(xf_out)
        return {**context,
                "timestep_embedding": context["timestep_embedding"] + self.proj(xf_out[:, -1]),
                "context_embedding": xf_out}
