"""CLAP text embedder (frozen audio-text conditioning), on its offline path.

Counterpart of `FrozenCLAPTextEmbedder` in xdiffusion_tpu/layers/clap.py: a
host-side context preprocessor, context["text_prompts"] ->
context["clap_embeddings"] (B, embedding_dim) fp32 on the CPU (the
diffusion process moves it to its device). The JAX package runs the real
CLAP text tower when its weights are cached and otherwise a hash
embedding; the repository holds no CLAP weights, so the port has the hash
path only: the sha256 of the prompt seeds numpy's generator, whose
embedding_dim normal draws are divided by their norm (no + 1e-8, unlike
`_HashEmbedFallback`), bit-equal to the JAX package's. `encoder="pretrained"`
asks for the real tower and raises, as the port's T5 and CLIP embedders
do. A context that already holds `clap_embeddings` passes through.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch


class FrozenCLAPTextEmbedder:
    host_side = True

    def __init__(self, embedding_dim: int = 1024, version: str = "laion/clap-htsat-unfused",
                 encoder: str = "hash", **kwargs):
        if encoder != "hash":
            raise NotImplementedError(
                f"FrozenCLAPTextEmbedder: the {encoder!r} encoder ({version}) is not ported; "
                "only the offline hash embedding is")
        self.embedding_dim = int(embedding_dim)
        self.version = version

    def _embed_one(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        v = np.random.default_rng(seed).normal(size=self.embedding_dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "clap_embeddings" in context:
            return context
        new_context = dict(context)
        new_context["clap_embeddings"] = torch.from_numpy(
            np.stack([self._embed_one(t) for t in context["text_prompts"]]))
        return new_context
