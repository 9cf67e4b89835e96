"""Timestep embeddings, the context-transformer glue and the offline text
embedder.

Counterpart of `sinusoidal_embedding`, `glide_timestep_embedding`,
`TimestepEmbeddingProjection`, `RunProjection`, `_HashEmbedFallback` and
`T5TextEmbedder` in xdiffusion_tpu/layers/embedding.py.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np

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


def glide_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                             scale: float = 1.0, flip_sin_to_cos: bool = True
                             ) -> torch.Tensor:
    """GLIDE/DiT sinusoidal features (B,) -> (B, dim) fp32: frequencies
    exp(-log(max_period) * arange(half) / half) (a `half` divisor, unlike
    `sinusoidal_embedding`'s `half - 1`), cos first when flip_sin_to_cos, a
    zero column appended for an odd dim."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = scale * (t.float()[:, None] * freqs[None, :])
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


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


class _HashEmbedFallback:
    """Deterministic prompt -> (length, dim) fp32 embedding for want of a
    pretrained text encoder: the sha256 of the prompt seeds numpy's
    generator, whose normal draws are normalised per row. Bit-equal to the
    JAX package's fallback."""

    def __init__(self, length: int, dim: int):
        self.length = int(length)
        self.dim = int(dim)

    def __call__(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(self.length, self.dim)).astype("float32")
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)


class T5TextEmbedder:
    """Host-side context preprocessor: context["text_prompts"] -> (B, L, D)
    fp32 embeddings at context[context_key], on the CPU (the diffusion
    process moves them to its device).

    The port has the offline path only, the hash embedding the JAX package
    also takes when no T5 weights are at hand. `encoder="pretrained"` asks
    for the real T5 encoder, which waits for its weights in the repository,
    and raises."""

    host_side = True

    def __init__(self, max_length: int = 77, version: str = "google/t5-v1_1-base",
                 context_key: str = "t5_text_embeddings", embedding_dim: int = 768,
                 include_temporal: bool = False, encoder: str = "hash", **kwargs):
        if encoder != "hash":
            raise NotImplementedError(
                f"T5TextEmbedder: the {encoder!r} encoder ({version}) is not ported; "
                "only the offline hash embedding is")
        self.context_key = context_key
        self.max_length = int(max_length)
        self.version = version
        self.include_temporal = bool(include_temporal)
        self._fallback = _HashEmbedFallback(max_length, embedding_dim)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or self.context_key in context:
            return context
        emb = torch.from_numpy(np.stack([self._fallback(t) for t in context["text_prompts"]]))
        if self.include_temporal:
            emb = emb[:, None]
        new_context = dict(context)
        new_context[self.context_key] = emb
        return new_context
