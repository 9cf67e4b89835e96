"""Conditioning-context preprocessors and adapters the ported configs name.

Counterpart of `Identity`, `IgnoreContextAdapter`, `IgnoreInputPreprocessor`,
`UnconditionalClassesAdapter`, `UnconditionalTextPromptsAdapter`,
`TextPromptsPreprocessor`, `TextTokenAdapter`, `ContextEmbeddingAdapter`,
`T5TextPromptsPreprocessor`, `TextTokenProjectionAdapter`,
`TextEmbeddingsAdapter`, `CLIPTextPromptsPreprocessor`,
`UnconditionalEmbeddingAdapter`, `SD3EncoderStack`,
`SD3TextPromptsPreprocessor` and `SpatialBatchForVideo` in
xdiffusion_tpu/context.py.

Host-side preprocessors turn prompt strings into CPU tensors (int32 token
ids, fp32 embeddings); the diffusion process and the trainers move them to
the device. The T5 and CLIP tokenizers are the JAX package's offline
fallbacks: the byte-level BPE, its ids folded into each vocabulary.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

# The text signals a prompt resolves to, which the guidance adapters blank.
TEXT_EMBEDDING_KEYS = ("text_embeddings", "t5_text_embeddings", "clip_text_embeddings")


def _zeros_like(x):
    """Zeros of an array signal's shape and dtype: a tensor or a numpy array."""
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) else np.zeros_like(x)


class Identity:
    """No-op adapter; the target of `torch.nn.Identity` in configs."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x=None, *args, **kwargs):
        return x


class IgnoreContextAdapter:
    """Pass-through context preprocessor."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs) -> Dict:
        return context


class IgnoreInputPreprocessor:
    """Pass-through input preprocessor."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, x, context: Dict = None, noise_scheduler=None, **kwargs):
        return x


class UnconditionalClassesAdapter:
    """Guidance adapter: every class label becomes the learned null class,
    id `num_classes` (class-conditional networks embed num_classes + 1
    labels)."""

    def __init__(self, num_classes: int, **kwargs):
        self._num_classes = int(num_classes)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        new_context = dict(context)
        new_context["classes"] = torch.full_like(context["classes"], self._num_classes)
        return new_context


class UnconditionalTextPromptsAdapter:
    """Guidance adapter: empty-prompt conditioning. Blanks the prompt strings
    before the text embedder runs; zeroes tokens and embeddings that are
    already in the context, tensors or numpy arrays (the empty prompt's
    stand-in), in their own dtype."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs) -> Dict:
        new_context = dict(context)
        if "text_prompts" in context:
            new_context["text_prompts"] = [""] * len(context["text_prompts"])
        for key in ("text_tokens",) + TEXT_EMBEDDING_KEYS:
            if key in context and not isinstance(context[key], (list, tuple)):
                new_context[key] = _zeros_like(context[key])
        return new_context


class UnconditionalEmbeddingAdapter:
    """Guidance adapter for frozen-embedding conditioning: zeroes the text
    embeddings in the context (`embedding_shape` is accepted and unused, as
    in the JAX package)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs) -> Dict:
        new_context = dict(context)
        for key in TEXT_EMBEDDING_KEYS:
            if key in context and hasattr(context[key], "shape"):
                new_context[key] = _zeros_like(context[key])
        return new_context


class TextPromptsPreprocessor:
    """Host-side: context["text_prompts"] -> context["text_tokens"] (B,
    text_context_size) int32 by the GPT-2 byte-level BPE; the prompts leave
    the context."""

    def __init__(self, text_context_size: int = 128, **kwargs):
        from xdiffusion_tpu_torch.tokenizer import get_encoder

        self._text_context_size = int(text_context_size)
        self._encoder = get_encoder()

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_tokens" in context:
            return context
        new_context = dict(context)
        tokens = self._encoder.tokenize(list(new_context.pop("text_prompts")),
                                        self._text_context_size)
        new_context["text_tokens"] = torch.from_numpy(tokens)
        return new_context


class T5TextPromptsPreprocessor:
    """Host-side: context["text_prompts"] -> context["text_tokens"] (B,
    max_length) int32 in the T5 vocabulary: the byte-level BPE % 32128 (the
    real T5 tokenizer's files are not in the repository); the prompts leave
    the context."""

    def __init__(self, max_length: int = 77, **kwargs):
        from xdiffusion_tpu_torch.tokenizer import get_encoder

        self._max_length = int(max_length)
        self._encoder = get_encoder()

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_tokens" in context:
            return context
        new_context = dict(context)
        tokens = self._encoder.tokenize(list(new_context.pop("text_prompts")),
                                        self._max_length) % 32128
        new_context["text_tokens"] = torch.from_numpy(tokens)
        return new_context


class CLIPTextPromptsPreprocessor:
    """Host-side: prompts -> context["text_tokens"] in the CLIP vocabulary
    (layers/clip.py's tokenizer); the prompts leave the context."""

    def __init__(self, text_sequence_length: int = 77, **kwargs):
        from xdiffusion_tpu_torch.layers.clip import FrozenCLIPTextTokenizer

        self._tokenizer = FrozenCLIPTextTokenizer(max_length=int(text_sequence_length))

    def __call__(self, context: Dict, **kwargs) -> Dict:
        new_context = self._tokenizer(context)
        new_context.pop("text_prompts", None)
        return new_context


class SD3EncoderStack:
    """SD3's three frozen text encoders (CLIP-L, CLIP-bigG and T5) and their
    joint-embedding recipe. Their weights are not in the repository, so the
    port has no stack: building one raises, and `SD3TextPromptsPreprocessor`
    takes the offline path, as the JAX package does when the towers are not
    cached."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SD3EncoderStack: the CLIP-L, CLIP-bigG and T5 encoders are not ported; "
            "SD3TextPromptsPreprocessor takes its offline hash embeddings")


class SD3TextPromptsPreprocessor:
    """Host-side: context["text_prompts"] -> context["text_embeddings"] (B,
    t5_max_length, joint_dim) and context["pooled_text_embeddings"] (B,
    pooled_dim), fp32 on the CPU; the prompts leave the context.

    The offline path of the JAX package: per prompt, the sha256 of the text
    seeds numpy's generator, whose normal draws are normalised per row
    (without the epsilon of `_HashEmbedFallback`), one table for the sequence
    and one row for the pooled vector. Bit-equal to the JAX package's
    fallback. Passing `encoders` (the real three-encoder stack) raises."""

    def __init__(self, first_clip_model_name: str = "openai/clip-vit-large-patch14",
                 first_clip_max_length: int = 77,
                 second_clip_model_name: str = "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k",
                 second_clip_max_length: int = 77, t5_model_name: str = "google/t5-v1_1-base",
                 t5_max_length: int = 128, joint_dim: int = 2048, pooled_dim: int = 2048,
                 encoders=None, **kwargs):
        if encoders is not None:
            raise NotImplementedError("SD3TextPromptsPreprocessor: the encoder stack is not "
                                      "ported; only the offline hash embeddings are")
        self.t5_max_length = int(t5_max_length)
        self.joint_dim = int(joint_dim)
        self.pooled_dim = int(pooled_dim)

    @staticmethod
    def _embed(text: str, length: int, dim: int) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        v = np.random.default_rng(seed).normal(size=(length, dim)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_embeddings" in context:
            return context
        new_context = dict(context)
        prompts = new_context.pop("text_prompts")
        new_context["text_embeddings"] = torch.from_numpy(np.stack(
            [self._embed(t, self.t5_max_length, self.joint_dim) for t in prompts]))
        new_context["pooled_text_embeddings"] = torch.from_numpy(np.stack(
            [self._embed(t, 1, self.pooled_dim)[0] for t in prompts]))
        return new_context


class TextTokenAdapter:
    """Conditioning-signal selector: the token batch."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs):
        return context["text_tokens"]


class ContextEmbeddingAdapter:
    """Conditioning-signal selector: context["context_embedding"]."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs):
        return context["context_embedding"]


class TextEmbeddingsAdapter:
    """Conditioning-signal selector: context["text_embeddings"], (B, L, C).
    `swap_context_channels` is accepted and does nothing: embeddings are
    (B, L, C) throughout, as in the JAX package."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs):
        return context["text_embeddings"]


class TextTokenProjectionAdapter:
    """Context head: context["text_embeddings"] = projections["text_tokens"](
    context["text_tokens"]), e.g. T5TextTokensToEmbedding. It owns no
    parameters; the projection is the score network's."""

    projection_key = "text_tokens"

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, projections: Dict) -> Dict:
        return {**context,
                "text_embeddings": projections["text_tokens"](context["text_tokens"], context)}


class SpatialBatchForVideo:
    """Context head kept for the configs that name it: a pass-through. The
    video UNets repeat each example's conditioning over its frames where
    they fold frames into the batch (score_networks/unet_3d.py
    `tile_context_over_frames`)."""

    def __init__(self, input_context_key: str = "", num_frames: int = 0, **kwargs):
        self.input_context_key = input_context_key

    def __call__(self, context: Dict, projections: Dict = None) -> Dict:
        return context
