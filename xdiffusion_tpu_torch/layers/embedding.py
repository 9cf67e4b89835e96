"""Timestep, label, position and patch embeddings, the context-transformer
glue and the offline text embedder.

Counterpart of `sinusoidal_embedding`, `glide_timestep_embedding`,
`TimestepEmbeddingProjection`, `DiTTimestepEmbedding`, `DiTLabelEmbedding`,
`DiTCombineEmbeddings`, `sincos_position_embedding_2d`, `PatchEmbed`,
`RunProjection`, `_HashEmbedFallback` and `T5TextEmbedder` in
xdiffusion_tpu/layers/embedding.py.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense


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


class DiTTimestepEmbedding(nn.Module):
    """DiT timestep embedder: GLIDE features at `frequency_embedding_size`
    -> fc1 -> SiLU -> fc2."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.out_features = hidden_size
        self.fc1 = Dense(frequency_embedding_size, hidden_size, dtype=dtype)
        self.fc2 = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, timestep: torch.Tensor, context: Dict = None) -> torch.Tensor:
        emb = glide_timestep_embedding(timestep, self.frequency_embedding_size)
        return self.fc2(F.silu(self.fc1(emb)))


class DiTLabelEmbedding(nn.Module):
    """Class-label table of num_classes + 1 rows; the last is the learned null
    class that classifier-free guidance maps labels to. `drop_prob` is
    accepted and ignored: training drops labels through the diffusion
    process's guidance mask."""

    def __init__(self, num_classes: int, hidden_size: int, drop_prob: float = 0.0,
                 unconditional_override: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.unconditional_override = unconditional_override
        self.compute_dtype = dtype
        self.out_features = hidden_size
        self.table = nn.Embedding(num_classes + 1, hidden_size)

    def forward(self, labels: torch.Tensor, context: Dict = None) -> torch.Tensor:
        if self.unconditional_override:
            labels = torch.full_like(labels, self.num_classes)
        return self.table(labels.long()).to(self.compute_dtype)


class DiTCombineEmbeddings:
    """Context-head op: context[output_context_key] = the sum of the
    `source_context_keys` entries, in order."""

    def __init__(self, output_context_key: str, source_context_keys, **kwargs):
        self.output_context_key = output_context_key
        self.source_context_keys = list(source_context_keys)

    def __call__(self, context: Dict, projections: Dict = None) -> Dict:
        new_context = dict(context)
        x = context[self.source_context_keys[0]]
        for key in self.source_context_keys[1:]:
            x = x + context[key]
        new_context[self.output_context_key] = x
        return new_context


# The reference configs' spelling.
DiTCombineEmbeddngs = DiTCombineEmbeddings


def sincos_position_embedding_2d(embed_dim: int, grid_h: int, grid_w: int,
                                 base_size: int = None) -> torch.Tensor:
    """Fixed 2-D sin-cos position table (grid_h * grid_w, embed_dim), fp32,
    built in float64 numpy: the first half of the channels encodes the
    column, the second half the row. With `base_size`, positions are
    rescaled to arange(g) / (g / base_size)."""
    assert embed_dim % 4 == 0

    def one_dim(dim, positions):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / (10000.0 ** omega)
        out = np.einsum("p,f->pf", positions, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_y = np.arange(grid_h, dtype=np.float32)
    grid_x = np.arange(grid_w, dtype=np.float32)
    if base_size is not None:
        grid_y = grid_y / (grid_h / base_size)
        grid_x = grid_x / (grid_w / base_size)
    yy, xx = np.meshgrid(grid_y.astype(np.float64), grid_x.astype(np.float64), indexing="ij")
    emb = np.concatenate([one_dim(embed_dim // 2, xx.reshape(-1)),
                          one_dim(embed_dim // 2, yy.reshape(-1))], axis=1)
    return torch.from_numpy(emb.astype(np.float32))


class PatchEmbed(nn.Module):
    """NHWC image -> (B, N, embed_dim) patch tokens by a stride-p convolution
    (`proj`, OIHW)."""

    def __init__(self, in_channels: int, patch_size: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.proj = ConvNHWC(in_channels, embed_dim, patch_size, stride=patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"PatchEmbed: {(h, w)} not divisible by {p}")
        return self.proj(x).reshape(b, (h // p) * (w // p), self.embed_dim)


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
