"""CLIP text conditioning on the JAX package's offline paths.

Counterpart of `FrozenCLIPTextTokenizer` and `FrozenCLIPEmbedder` in
xdiffusion_tpu/layers/clip.py. The JAX package runs the real CLIP tokenizer
and text model when their weights are cached locally, and otherwise falls
back to the byte-level BPE (ids folded into the CLIP vocabulary) and to the
sha256-seeded hash embedding. The repository holds no CLIP weights and the
port does not try to load any: it runs those fallbacks, which give the same
ids and bit-equal embeddings as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from xdiffusion_tpu_torch.layers.embedding import _HashEmbedFallback

CLIP_VOCAB_SIZE = 49408
MEMO_PROMPTS = 256  # embeddings kept (about 236 KB each at 77 x 768)


class FrozenCLIPTextTokenizer:
    """Host-side: context["text_prompts"] -> context["text_tokens"] (B,
    max_length) int32, byte-level BPE % 49408. The checkpoint name the
    configs give (`version`) is accepted and unused."""

    def __init__(self, max_length: int = 77, **kwargs):
        from xdiffusion_tpu_torch.tokenizer import get_encoder

        self.max_length = int(max_length)
        self._bpe = get_encoder()

    def tokenize(self, texts: List[str]) -> np.ndarray:
        return self._bpe.tokenize(texts, self.max_length) % CLIP_VOCAB_SIZE

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_tokens" in context:
            return context
        return {**context,
                "text_tokens": torch.from_numpy(self.tokenize(list(context["text_prompts"])))}


class FrozenCLIPEmbedder:
    """Host-side: context["text_prompts"] -> context["text_embeddings"] (B,
    max_length, embedding_dim) fp32 on the CPU, by the hash embedding of
    each prompt (the diffusion process moves it to its device). The
    embedding is a pure function of the prompt, so each prompt's is kept
    once it is made (`version` is accepted and unused): training draws from a few prompts, and the host path
    sets its pace (at most MEMO_PROMPTS are kept)."""

    def __init__(self, max_length: int = 77, embedding_dim: int = 768, **kwargs):
        self.max_length = int(max_length)
        self.embedding_dim = int(embedding_dim)
        self._fallback = _HashEmbedFallback(self.max_length, self.embedding_dim)
        self._memo: Dict[str, np.ndarray] = {}

    def _embed(self, prompt: str) -> np.ndarray:
        emb = self._memo.get(prompt)
        if emb is None:
            if len(self._memo) >= MEMO_PROMPTS:
                self._memo.clear()
            emb = self._memo[prompt] = self._fallback(prompt)
        return emb

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_embeddings" in context:
            return context
        emb = np.stack([self._embed(t) for t in context["text_prompts"]])
        return {**context, "text_embeddings": torch.from_numpy(emb)}
