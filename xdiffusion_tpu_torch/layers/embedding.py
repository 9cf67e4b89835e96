"""Timestep, label, position, patch and text embeddings, the
context-transformer heads and the frozen text embedders.

Counterpart of `sinusoidal_embedding`, `glide_timestep_embedding`,
`TimestepEmbeddingProjection`, `InvCosTimestepEmbeddingProjection`,
`LabelEmbeddingProjection`, `TextTokenProjection`, `DiTTimestepEmbedding`,
`DiTLabelEmbedding`, `DiTCombineEmbeddings`, `sincos_position_embedding_2d`,
`PatchEmbed`, `ContextProjection`, `T5TextTokensToEmbedding`,
`interleaved_frame_position_encoding`, `T5TextPromptsToTokens`,
`RunProjection`, `PooledTextEmbeddingsToTimestep`, `_HashEmbedFallback`,
`_FrozenEncoderCache`, `CLIPTextEmbedder` and `T5TextEmbedder` in
xdiffusion_tpu/layers/embedding.py.

The CLIP and T5 embedders run the frozen towers of layers/text_encoders.py
when their checkpoints load from local files, and otherwise the JAX
package's hash embedding; `T5TextPromptsToTokens` takes the T5 tokenizer
when its files are cached, else the byte-level BPE folded into the T5 range.
`T5TextTokensToEmbedding` is the JAX package's trainable table over the T5
vocabulary.
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
from xdiffusion_tpu_torch.layers.norm import LayerNorm


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


def interleaved_frame_position_encoding(length: int, dim: int,
                                        device=None) -> torch.Tensor:
    """The video wrappers' frame-position code, (length, dim) fp32:
    freq_i = 10000^(i / dim) over i < dim / 2 (a `dim` divisor on a
    dim/2-long index), sin and cos interleaved: pe[l] = [sin(l / f0),
    cos(l / f0), sin(l / f1), ...]."""
    freq = torch.exp(torch.arange(dim // 2, dtype=torch.float32, device=device) / dim
                     * math.log(10000.0))
    x = torch.arange(length, dtype=torch.float32, device=device)[:, None] / freq[None, :]
    return torch.stack([torch.sin(x), torch.cos(x)], dim=-1).reshape(length, dim)


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


class InvCosTimestepEmbeddingProjection(TimestepEmbeddingProjection):
    """`TimestepEmbeddingProjection` of the warped time arctan(exp(-logsnr /
    2)) / (pi / 2), the logSNR clipped to [clip_min, clip_max] first: the
    continuous-time models' bounded time signal."""

    def __init__(self, num_features: int, time_embedding_mult: int = 4,
                 max_time: float = 1000.0, clip_min: float = -20.0, clip_max: float = 20.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_features, time_embedding_mult, max_time, dtype)
        self.clip_min, self.clip_max = clip_min, clip_max

    def forward(self, timestep: torch.Tensor, context: Dict = None) -> torch.Tensor:
        warped = torch.atan(torch.exp(
            -0.5 * timestep.float().clamp(self.clip_min, self.clip_max))) / (0.5 * math.pi)
        return super().forward(warped, context)


class LabelEmbeddingProjection(nn.Module):
    """Class-label table with a NULL row for classifier-free guidance (id
    `num_classes`, which `UnconditionalClassesAdapter` writes): (B,) labels
    -> (B, embedding_dim) in `dtype`, table `embed` (num_classes + 1, D)."""

    def __init__(self, num_classes: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embed = nn.Embedding(num_classes + 1, embedding_dim)

    def forward(self, classes: torch.Tensor, context: Dict = None) -> torch.Tensor:
        return self.embed(classes.long()).to(self.compute_dtype)


class TextTokenProjection(nn.Module):
    """Token-id table: (B, L) ids -> (B, L, width) in `dtype`."""

    def __init__(self, token_vocabulary_size: int, width: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embed = nn.Embedding(token_vocabulary_size, width)

    def forward(self, tokens: torch.Tensor, context: Dict = None) -> torch.Tensor:
        return self.embed(tokens.long()).to(self.compute_dtype)


class T5TextTokensToEmbedding(TextTokenProjection):
    """T5-vocabulary ids -> (B, L, d_model): a trainable table, the JAX
    package's offline stand-in for the frozen T5 encoder."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 768,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(vocab_size, d_model, dtype)


class T5TextPromptsToTokens:
    """Host-side projection: prompt strings -> (B, max_length) int32 ids on
    the CPU. The T5 tokenizer of `model_name` when its files are cached
    locally (padded and truncated to max_length), else the byte-level BPE
    folded into the T5 vocabulary (% 32128), as in the JAX package."""

    host_side = True

    def __init__(self, max_length: int = 77, model_name: str = "google/t5-v1_1-base",
                 **kwargs):
        from xdiffusion_tpu_torch.layers.text_encoders import local_tokenizer

        self.max_length = int(max_length)
        self.model_name = model_name
        self._tokenizer = local_tokenizer(model_name)
        if self._tokenizer is None:
            from xdiffusion_tpu_torch.tokenizer import get_encoder

            self._bpe = get_encoder()

    def __call__(self, prompts, context: Dict = None) -> torch.Tensor:
        if self._tokenizer is not None:
            out = self._tokenizer(list(prompts), max_length=self.max_length,
                                  padding="max_length", truncation=True, return_tensors="np")
            return torch.from_numpy(out["input_ids"].astype(np.int32))
        return torch.from_numpy(self._bpe.tokenize(list(prompts), self.max_length) % 32128)


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
                                 base_size: int = None, lewei_scale: float = 1.0) -> torch.Tensor:
    """Fixed 2-D sin-cos position table (grid_h * grid_w, embed_dim), fp32,
    built in float64 numpy: the first half of the channels encodes the
    column, the second half the row. With `base_size`, positions are
    rescaled to arange(g) / (g / base_size) / lewei_scale (DiT passes
    base_size 16, PixArt the grid and its config's lewei_scale)."""
    assert embed_dim % 4 == 0

    def one_dim(dim, positions):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / (10000.0 ** omega)
        out = np.einsum("p,f->pf", positions, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_y = np.arange(grid_h, dtype=np.float32)
    grid_x = np.arange(grid_w, dtype=np.float32)
    if base_size is not None:
        grid_y = grid_y / (grid_h / base_size) / lewei_scale
        grid_x = grid_x / (grid_w / base_size) / lewei_scale
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


class ContextProjection(nn.Module):
    """Context head: context[output_context_key] = fc2(gelu_tanh(fc1(
    context[input_context_key]))), e.g. frozen text embeddings projected to
    the cross-attention width."""

    def __init__(self, input_context_key: str, output_context_key: str, in_features: int,
                 hidden_features: int, out_features: int, custom_initialization: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_context_key = input_context_key
        self.output_context_key = output_context_key
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)

    def forward(self, context: Dict, projections: Dict = None) -> Dict:
        x = self.fc2(F.gelu(self.fc1(context[self.input_context_key]), approximate="tanh"))
        return {**context, self.output_context_key: x}


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


class PooledTextEmbeddingsToTimestep(nn.Module):
    """Imagen's pooled-text head: a learned query attention-pools
    context["text_embeddings"] (B, L, D) over heads of width
    `attention_pooling_heads`; the pooled vector, LayerNormed, SiLU'd and
    projected to `time_embedding_dim`, is added to
    context["timestep_embedding"]. A single query against L keys: a plain
    einsum, as in the JAX package."""

    def __init__(self, text_embedding_dim: int, time_embedding_dim: int,
                 attention_pooling_heads: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = text_embedding_dim
        self.num_heads = max(1, d // int(attention_pooling_heads))
        self.head_dim = d // self.num_heads
        self.compute_dtype = dtype
        self.pool_query = nn.Parameter(torch.randn(d) * 0.02)
        self.q = Dense(d, d, dtype=dtype)
        self.k = Dense(d, d, dtype=dtype)
        self.v = Dense(d, d, dtype=dtype)
        self.norm = LayerNorm(d, dtype=dtype)
        self.to_time = Dense(d, time_embedding_dim, dtype=dtype)

    def forward(self, context: Dict, projections: Dict = None) -> Dict:
        emb = context["text_embeddings"].to(self.compute_dtype)
        b, length, d = emb.shape
        h, hd = self.num_heads, self.head_dim
        q = self.q(self.pool_query.to(self.compute_dtype).expand(b, 1, d))
        k, v = self.k(emb), self.v(emb)
        q, k, v = (t.reshape(b, -1, h, hd).transpose(1, 2) for t in (q, k, v))
        attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd), dim=-1)
        pooled = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, d)
        proj = self.to_time(F.silu(self.norm(pooled)))
        return {**context,
                "timestep_embedding": context["timestep_embedding"] + proj.float()}


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


class _FrozenEncoderCache:
    """Process-wide cache of the loaded frozen towers, keyed by (kind,
    version): "clip" or "t5". Loading is tried once; None means nothing
    loaded (no local files). An entry is (config, tower, tokenizer), the
    tower on the device the first caller asked for."""

    _loaded: Dict = {}

    @classmethod
    def get(cls, kind: str, version: str, device=None):
        key = (kind, version)
        if key not in cls._loaded:
            from xdiffusion_tpu_torch.layers import text_encoders as te

            loader = te.load_pretrained_clip_text if kind == "clip" else te.load_pretrained_t5
            cls._loaded[key] = loader(version, device=device)
        return cls._loaded[key]


def place_encoders(preprocessors, device) -> None:
    """Gives each host-side text embedder among `preprocessors` whose
    device is still unset (`encoder_device` None) `device`, where its frozen
    tower loads: a diffusion process passes its own."""
    for pre in preprocessors:
        if hasattr(pre, "encoder_device") and pre.encoder_device is None:
            pre.encoder_device = device


def tower_device(tower: nn.Module) -> torch.device:
    return next(tower.parameters()).device


def _tokenize(tok, prompts, max_length: int):
    return tok(list(prompts), truncation=True, max_length=max_length, padding="max_length",
               return_tensors="np")


class CLIPTextEmbedder:
    """Host-side context preprocessor: context["text_prompts"] -> (B, D) fp32
    pooled embeddings at context[context_key], on the CPU (the diffusion
    process moves them to its device).

    Runs the CLIP text tower of `version` (layers/text_encoders.py) when it
    loads from local files, on its device (`encoder_device`: the card
    unless a process on the CPU sets it), and keeps each prompt's pooled
    vector; otherwise the first row of a one-row hash embedding per prompt,
    bit-equal to the JAX package's fallback."""

    host_side = True

    def __init__(self, max_length: int = 77, version: str = "openai/clip-vit-large-patch14",
                 context_key: str = "clip_text_embeddings", embedding_dim: int = 768,
                 **kwargs):
        self.context_key = context_key
        self.max_length = int(max_length)
        self.version = version
        self.encoder_device = None
        self._fallback = _HashEmbedFallback(1, embedding_dim)
        self._cache: Dict[str, np.ndarray] = {}

    def _encode_real(self, prompts):
        loaded = _FrozenEncoderCache.get("clip", self.version, self.encoder_device)
        if loaded is None:
            return None
        _, tower, tok = loaded
        todo = [p for p in prompts if p not in self._cache]
        if todo:
            ids = _tokenize(tok, todo, self.max_length)["input_ids"].astype(np.int32)
            with torch.no_grad():
                _, pooled = tower(torch.from_numpy(ids).to(tower_device(tower)))
            pooled = pooled.float().cpu().numpy()
            for i, p in enumerate(todo):
                self._cache[p] = pooled[i]
        return torch.from_numpy(np.stack([self._cache[p] for p in prompts]))

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or self.context_key in context:
            return context
        prompts = list(context["text_prompts"])
        emb = self._encode_real(prompts)
        if emb is None:
            emb = torch.from_numpy(np.stack([self._fallback(t)[0] for t in prompts]))
        new_context = dict(context)
        new_context[self.context_key] = emb
        return new_context


class T5TextEmbedder:
    """Host-side context preprocessor: context["text_prompts"] -> (B, L, D)
    fp32 embeddings at context[context_key], on the CPU (the diffusion
    process moves them to its device); with `include_temporal`, (B, 1, L, D).

    Runs the T5 encoder of `version` when it loads from local files, on its
    device (`encoder_device`), with the tokenizer's padding mask, keeps each
    prompt's (hidden states, mask) and writes the int32 mask (B, L) to
    context["text_attention_mask"]; otherwise the hash embedding the JAX
    package also takes, and no mask."""

    host_side = True

    def __init__(self, max_length: int = 77, version: str = "google/t5-v1_1-base",
                 context_key: str = "t5_text_embeddings", embedding_dim: int = 768,
                 include_temporal: bool = False, **kwargs):
        self.context_key = context_key
        self.max_length = int(max_length)
        self.version = version
        self.include_temporal = bool(include_temporal)
        self.encoder_device = None
        self._fallback = _HashEmbedFallback(max_length, embedding_dim)
        self._cache: Dict[str, tuple] = {}

    def _encode_real(self, prompts):
        loaded = _FrozenEncoderCache.get("t5", self.version, self.encoder_device)
        if loaded is None:
            return None
        _, tower, tok = loaded
        todo = [p for p in prompts if p not in self._cache]
        if todo:
            enc = _tokenize(tok, todo, self.max_length)
            ids = enc["input_ids"].astype(np.int32)
            mask = enc["attention_mask"].astype(np.int32)
            dev = tower_device(tower)
            with torch.no_grad():
                hidden = tower(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev))
            hidden = hidden.float().cpu().numpy()
            for i, p in enumerate(todo):
                self._cache[p] = (hidden[i], mask[i])
        emb = np.stack([self._cache[p][0] for p in prompts])
        mask = np.stack([self._cache[p][1] for p in prompts])
        return torch.from_numpy(emb), torch.from_numpy(mask)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or self.context_key in context:
            return context
        prompts = list(context["text_prompts"])
        real = self._encode_real(prompts)
        new_context = dict(context)
        if real is None:
            emb = torch.from_numpy(np.stack([self._fallback(t) for t in prompts]))
        else:
            emb, new_context["text_attention_mask"] = real
        if self.include_temporal:
            emb = emb[:, None]
        new_context[self.context_key] = emb
        return new_context


class CLIPTextTokenProjection(nn.Module):
    """CLIP-vocabulary token ids (B, L) -> (B, L, width) sequence
    embeddings: the offline path the JAX package takes for want of the
    frozen CLIP text transformer, a trainable `token_embed` table plus a
    learned `pos_embed` (text_sequence_length, width)."""

    def __init__(self, text_sequence_length: int = 77, vocab_size: int = 49408,
                 width: int = 768, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__()
        self.compute_dtype = dtype
        self.token_embed = nn.Embedding(vocab_size, width)
        self.pos_embed = nn.Parameter(0.01 * torch.randn(text_sequence_length, width))

    def forward(self, tokens: torch.Tensor, context: Dict = None) -> torch.Tensor:
        h = self.token_embed(tokens.long()).to(self.compute_dtype)
        return h + self.pos_embed[None, :h.shape[1]].to(h.dtype)


class SanaPromptToTextEmbedding:
    """Host-side prompt embedder for Sana: context[input_key] (prompts) ->
    (B, max_length, embedding_dim) fp32 at context[output_key], on the CPU.
    The offline path only, the hash embedding at the Gemma-2 width that the
    JAX package takes without the encoder's weights; a context that already
    holds `output_key` passes through."""

    host_side = True

    def __init__(self, text_encoder_model_name: str = "google/gemma-2-2b-it",
                 max_length: int = 300, input_key: str = "text_prompts",
                 output_key: str = "text_embeddings", use_bfloat16: bool = False,
                 embedding_dim: int = 2304, **kwargs):
        self.input_key = input_key
        self.output_key = output_key
        self.context_key = output_key
        self._fallback = _HashEmbedFallback(int(max_length), int(embedding_dim))

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if self.input_key not in context or self.output_key in context:
            return context
        emb = np.stack([self._fallback(t) for t in context[self.input_key]])
        new_context = dict(context)
        new_context[self.output_key] = torch.from_numpy(emb)
        return new_context
