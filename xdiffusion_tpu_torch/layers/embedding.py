"""Timestep embedding and the context-transformer glue.

Counterpart of `sinusoidal_embedding`, `TimestepEmbeddingProjection` and
`RunProjection` in xdiffusion_tpu/layers/embedding.py.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Dense


def sinusoidal_embedding(t: torch.Tensor, embedding_dim: int, max_time: float = 1000.0,
                         theta: float = 10000.0) -> torch.Tensor:
    """(B,) times -> (B, embedding_dim) features, sin first; times are scaled
    by 1000 / max_time."""
    x = t.float() * (1000.0 / max_time)
    half = embedding_dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(theta) / (half - 1))
    )
    args = x[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepEmbeddingProjection(nn.Module):
    """Sinusoidal features -> fc1 -> SiLU -> fc2, width
    num_features * time_embedding_mult."""

    def __init__(self, num_features: int, time_embedding_mult: int = 4,
                 max_time: float = 1000.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features = num_features
        self.max_time = max_time
        self.out_features = num_features * time_embedding_mult
        self.fc1 = Dense(num_features, self.out_features, dtype=dtype)
        self.fc2 = Dense(self.out_features, self.out_features, dtype=dtype)

    def forward(self, timestep: torch.Tensor, context: Dict = None) -> torch.Tensor:
        emb = sinusoidal_embedding(timestep, self.num_features, self.max_time)
        return self.fc2(F.silu(self.fc1(emb)))


class RunProjection:
    """Context-transformer head: context[out_key] = proj(context[in_key]),
    with the projection taken from the score network's projection dict."""

    def __init__(self, input_context_key: str, output_context_key: str,
                 projection_key: str, **kwargs):
        self.input_context_key = input_context_key
        self.output_context_key = output_context_key
        self.projection_key = projection_key

    def __call__(self, context: Dict, projections: Dict) -> Dict:
        if self.input_context_key not in context:
            raise KeyError(
                f"{self.input_context_key} not found for projection {self.projection_key}."
            )
        new_context = dict(context)
        new_context[self.output_context_key] = projections[self.projection_key](
            context[self.input_context_key], context=context
        )
        return new_context
