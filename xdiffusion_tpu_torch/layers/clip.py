"""Frozen CLIP text conditioning.

Counterpart of `FrozenCLIPTextTokenizer` and `FrozenCLIPEmbedder` in
xdiffusion_tpu/layers/clip.py. When the CLIP checkpoint of `version` is
cached locally, the tokenizer is its `CLIPTokenizer` and the embedder runs
the port's CLIP text tower (layers/text_encoders.py, loaded by
`load_pretrained_clip_text`; the JAX package runs `transformers`'
FlaxCLIPTextModel there), whose `last_hidden_state` it writes. Otherwise
they fall back, as the JAX package does, to the byte-level BPE (ids folded
into the CLIP vocabulary) and to the sha256-seeded hash embedding, which
give the same ids and bit-equal embeddings as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from xdiffusion_tpu_torch.layers.embedding import _HashEmbedFallback, _tokenize, tower_device

CLIP_VOCAB_SIZE = 49408
MEMO_PROMPTS = 256  # hash embeddings kept (about 236 KB each at 77 x 768)


class FrozenCLIPTextTokenizer:
    """Host-side: context["text_prompts"] -> context["text_tokens"] (B,
    max_length) int32: the CLIPTokenizer of `version` when its files are
    cached locally, else the byte-level BPE % 49408."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14", max_length: int = 77,
                 **kwargs):
        from xdiffusion_tpu_torch.layers.text_encoders import local_tokenizer

        self.max_length = int(max_length)
        self._tokenizer = local_tokenizer(version, "CLIPTokenizer")
        if self._tokenizer is None:
            from xdiffusion_tpu_torch.tokenizer import get_encoder

            self._bpe = get_encoder()

    def tokenize(self, texts: List[str]) -> np.ndarray:
        if self._tokenizer is not None:
            return _tokenize(self._tokenizer, texts, self.max_length)["input_ids"].astype(np.int32)
        return self._bpe.tokenize(texts, self.max_length) % CLIP_VOCAB_SIZE

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "text_tokens" in context:
            return context
        return {**context,
                "text_tokens": torch.from_numpy(self.tokenize(list(context["text_prompts"])))}


class FrozenCLIPEmbedder:
    """Host-side: context["text_prompts"] -> context["text_embeddings"] (B,
    max_length, embedding_dim) fp32 on the CPU (the diffusion process moves
    it to its device).

    The CLIP tower of `version` (its `last_hidden_state`, ids without a
    padding mask, as the JAX package runs it) when it loads from local
    files, tried once at the first call, on `encoder_device` (the card
    unless a process on the CPU sets it). Otherwise the hash embedding of
    each prompt, a pure function of the prompt: each is kept once it is made
    (at most MEMO_PROMPTS), since training draws from a few prompts and the
    host path sets its pace."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14", max_length: int = 77,
                 embedding_dim: int = 768, **kwargs):
        self.version = version
        self.max_length = int(max_length)
        self.embedding_dim = int(embedding_dim)
        self.encoder_device = None
        self._loaded = None
        self._load_attempted = False
        self._fallback = _HashEmbedFallback(self.max_length, self.embedding_dim)
        self._memo: Dict[str, np.ndarray] = {}

    def _tower(self):
        if not self._load_attempted:
            from xdiffusion_tpu_torch.layers.text_encoders import load_pretrained_clip_text

            self._load_attempted = True
            self._loaded = load_pretrained_clip_text(self.version, device=self.encoder_device)
        return self._loaded

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
        prompts = list(context["text_prompts"])
        loaded = self._tower()
        if loaded is not None:
            _, tower, tok = loaded
            ids = _tokenize(tok, prompts, self.max_length)["input_ids"].astype(np.int32)
            with torch.no_grad():
                hidden, _ = tower(torch.from_numpy(ids).to(tower_device(tower)))
            return {**context, "text_embeddings": hidden.float().cpu()}
        emb = np.stack([self._embed(t) for t in prompts])
        return {**context, "text_embeddings": torch.from_numpy(emb)}
