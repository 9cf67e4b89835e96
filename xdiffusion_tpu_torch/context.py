"""Conditioning-context preprocessors and adapters the ported configs name.

Counterpart of `Identity`, `NullContextAdapter`, `IgnoreContextAdapter`,
`IgnoreInputPreprocessor`, `UnconditionalClassesAdapter`,
`UnconditionalTextPromptsAdapter`, `TextPromptsPreprocessor`,
`TextTokenAdapter`, `ContextEmbeddingAdapter`, `T5TextPromptsPreprocessor`,
`TextTokenProjectionAdapter`, `TextEmbeddingsAdapter`,
`CLIPTextPromptsPreprocessor`, `UnconditionalEmbeddingAdapter`,
`SD3EncoderStack`, `SD3TextPromptsPreprocessor` and `SpatialBatchForVideo`
in xdiffusion_tpu/context.py.

Host-side preprocessors turn prompt strings into CPU tensors (int32 token
ids, fp32 embeddings); the diffusion process and the trainers move them to
the device. The T5 and CLIP tokenizers are HF's when their files are cached
locally, else the JAX package's offline fallback, the byte-level BPE with
its ids folded into each vocabulary. SD3's preprocessor runs the three
frozen towers (layers/text_encoders.py) when all three load from local
files, else its hash embeddings.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, List

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


class NullContextAdapter:
    """Conditioning-signal selector that selects nothing: None."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs):
        return None


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
    max_length) int32 in the T5 vocabulary: the T5 tokenizer of `model_name`
    when its files are cached locally, else the byte-level BPE % 32128; the
    prompts leave the context."""

    def __init__(self, max_length: int = 77, model_name: str = "google/t5-v1_1-base",
                 **kwargs):
        from xdiffusion_tpu_torch.layers.text_encoders import local_tokenizer

        self._max_length = int(max_length)
        self._tokenizer = local_tokenizer(model_name)
        if self._tokenizer is None:
            from xdiffusion_tpu_torch.tokenizer import get_encoder

            self._encoder = get_encoder()

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_tokens" in context:
            return context
        new_context = dict(context)
        prompts = list(new_context.pop("text_prompts"))
        if self._tokenizer is not None:
            tokens = self._tokenizer(prompts, max_length=self._max_length, padding="max_length",
                                     truncation=True, return_tensors="np")["input_ids"]
            tokens = tokens.astype(np.int32)
        else:
            tokens = self._encoder.tokenize(prompts, self._max_length) % 32128
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


def _token_fn(tok):
    """tokenize(prompts, max_length) -> (B, max_length) int32 ids by an HF
    tokenizer, padded to max_length."""
    def tokenize(prompts, max_length):
        out = tok(list(prompts), padding="max_length", max_length=max_length, truncation=True,
                  return_tensors="np")
        return np.asarray(out["input_ids"], dtype=np.int32)
    return tokenize


class SD3EncoderStack:
    """SD3's three frozen text encoders and their joint-embedding recipe
    (arXiv:2403.03206 §4):

    - sequence: the penultimate hidden states of the two CLIP towers joined
      channel-wise (77 x 2048), zero-padded along channels to the T5 width
      (or the T5 hiddens to theirs), then joined with the T5 hiddens along
      the sequence;
    - pooled: the two CLIP towers' projected pooled vectors joined.

    `clip1`, `clip2` and `t5` are (config, tower, tokenize) triples, where
    tokenize(prompts, max_length) gives (B, max_length) int32 ids: built
    from local checkpoints by `for_pretrained`, or given directly. Each
    tower runs on its own device, without a padding mask, as in the JAX
    package; the result is fp32 numpy."""

    def __init__(self, clip1, clip2, t5, clip1_len: int, clip2_len: int, t5_len: int):
        self._clip1, self._clip2, self._t5 = clip1, clip2, t5
        self._lens = (int(clip1_len), int(clip2_len), int(t5_len))

    @classmethod
    def for_pretrained(cls, first: str, second: str, t5_name: str, clip1_len: int,
                       clip2_len: int, t5_len: int, device=None):
        """The stack of the locally cached checkpoints on `device` (the card
        unless the CPU is asked for); None if any of the three is missing."""
        from xdiffusion_tpu_torch.layers.text_encoders import (
            load_pretrained_clip_text,
            load_pretrained_t5,
        )

        c1 = load_pretrained_clip_text(first, with_projection=True, device=device)
        c2 = load_pretrained_clip_text(second, with_projection=True, device=device)
        t5 = load_pretrained_t5(t5_name, device=device)
        if c1 is None or c2 is None or t5 is None:
            return None
        return cls(*((cfg, tower, _token_fn(tok)) for cfg, tower, tok in (c1, c2, t5)),
                   clip1_len, clip2_len, t5_len)

    def __call__(self, prompts: List[str]):
        from xdiffusion_tpu_torch.layers.embedding import tower_device

        def run(triple, length, **kwargs):
            _, tower, tokenize = triple
            ids = torch.from_numpy(tokenize(prompts, length)).to(tower_device(tower))
            return tower(ids, **kwargs)

        l1, l2, lt = self._lens
        with torch.no_grad():
            clips = [run(self._clip1, l1, penultimate=True), run(self._clip2, l2, penultimate=True)]
            t5_seq = run(self._t5, lt).float().cpu().numpy()
        clip_seq = np.concatenate([seq.float().cpu().numpy() for seq, _ in clips], axis=-1)
        pooled = np.concatenate([vec.float().cpu().numpy() for _, vec in clips], axis=-1)
        dc, dt = clip_seq.shape[-1], t5_seq.shape[-1]
        if dt > dc:
            clip_seq = np.pad(clip_seq, ((0, 0), (0, 0), (0, dt - dc)))
        elif dc > dt:
            t5_seq = np.pad(t5_seq, ((0, 0), (0, 0), (0, dc - dt)))
        seq = np.concatenate([clip_seq, t5_seq], axis=-2)
        return seq.astype(np.float32), pooled.astype(np.float32)


class SD3TextPromptsPreprocessor:
    """Host-side: context["text_prompts"] -> context["text_embeddings"] (B,
    L, joint_dim) and context["pooled_text_embeddings"] (B, pooled_dim),
    fp32 on the CPU; the prompts leave the context.

    The three frozen encoders (`SD3EncoderStack`) when all three load from
    local files (tried once, at the first call, on `encoder_device`: the
    card unless a process on the CPU sets it) or when `encoders` is given:
    L is the two CLIP lengths' 77 plus the T5 length. Otherwise, with a
    warning, the JAX package's offline path: per prompt, the sha256 of the
    text seeds numpy's generator, whose normal draws are normalised per row
    (without the epsilon of `_HashEmbedFallback`), one table of t5_max_length
    rows for the sequence and one row for the pooled vector, bit-equal to
    the JAX package's fallback."""

    def __init__(self, first_clip_model_name: str = "openai/clip-vit-large-patch14",
                 first_clip_max_length: int = 77,
                 second_clip_model_name: str = "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k",
                 second_clip_max_length: int = 77, t5_model_name: str = "google/t5-v1_1-base",
                 t5_max_length: int = 128, joint_dim: int = 2048, pooled_dim: int = 2048,
                 encoders: "SD3EncoderStack | None" = None, **kwargs):
        self.first_clip_model_name = first_clip_model_name
        self.first_clip_max_length = int(first_clip_max_length)
        self.second_clip_model_name = second_clip_model_name
        self.second_clip_max_length = int(second_clip_max_length)
        self.t5_model_name = t5_model_name
        self.t5_max_length = int(t5_max_length)
        self.joint_dim = int(joint_dim)
        self.pooled_dim = int(pooled_dim)
        self.encoder_device = None
        self._encoders = encoders
        self._load_attempted = encoders is not None

    def _encoder_stack(self):
        if not self._load_attempted:
            self._load_attempted = True
            self._encoders = SD3EncoderStack.for_pretrained(
                self.first_clip_model_name, self.second_clip_model_name, self.t5_model_name,
                self.first_clip_max_length, self.second_clip_max_length, self.t5_max_length,
                device=self.encoder_device)
            if self._encoders is None:
                logging.getLogger(__name__).warning(
                    "SD3 text encoders not cached locally (%s / %s / %s); falling back to "
                    "hash embeddings", self.first_clip_model_name,
                    self.second_clip_model_name, self.t5_model_name)
        return self._encoders

    @staticmethod
    def _embed(text: str, length: int, dim: int) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        v = np.random.default_rng(seed).normal(size=(length, dim)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_embeddings" in context:
            return context
        new_context = dict(context)
        prompts = list(new_context.pop("text_prompts"))
        stack = self._encoder_stack()
        if stack is not None:
            emb, pooled = stack(prompts)
        else:
            emb = np.stack([self._embed(t, self.t5_max_length, self.joint_dim) for t in prompts])
            pooled = np.stack([self._embed(t, 1, self.pooled_dim)[0] for t in prompts])
        new_context["text_embeddings"] = torch.from_numpy(emb)
        new_context["pooled_text_embeddings"] = torch.from_numpy(pooled)
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
