"""CLAP text embedder (frozen audio-text conditioning).

Counterpart of `FrozenCLAPTextEmbedder` in xdiffusion_tpu/layers/clap.py: a
host-side context preprocessor, context["text_prompts"] ->
context["clap_embeddings"] (B, embedding_dim) fp32 on the CPU (the
diffusion process moves it to its device). As in the JAX package, the real
path is `transformers`' torch ClapTextModelWithProjection of `version` with
its tokenizer, loaded from local files once per version and process (None
when nothing loads), whose `text_embeds` are kept per prompt; the model
runs on `encoder_device`, the card unless a process on the CPU sets it.
Without it, the hash path: the sha256 of the prompt seeds numpy's
generator, whose embedding_dim normal draws are divided by their norm (no
+ 1e-8, unlike `_HashEmbedFallback`), bit-equal to the JAX package's. A
context that already holds `clap_embeddings` passes through.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch


class FrozenCLAPTextEmbedder:
    host_side = True
    _loaded: Dict = {}

    def __init__(self, embedding_dim: int = 1024, version: str = "laion/clap-htsat-unfused",
                 **kwargs):
        self.embedding_dim = int(embedding_dim)
        self.version = version
        self.encoder_device = None
        self._cache: Dict[str, np.ndarray] = {}

    @classmethod
    def _load(cls, version: str, device=None):
        if version not in cls._loaded:
            from xdiffusion_tpu_torch.layers.text_encoders import locally_cached
            from xdiffusion_tpu_torch.utils import resolve_device

            loaded = None
            if locally_cached(version):
                try:
                    from transformers import AutoTokenizer, ClapTextModelWithProjection

                    loaded = (ClapTextModelWithProjection.from_pretrained(
                        version, local_files_only=True).eval(),
                        AutoTokenizer.from_pretrained(version, local_files_only=True))
                except Exception:
                    loaded = None
            if loaded is not None:  # outside the try: a missing card raises
                loaded = (loaded[0].to(resolve_device(device)), loaded[1])
            cls._loaded[version] = loaded
        return cls._loaded[version]

    def _embed_real(self, prompts) -> Optional[np.ndarray]:
        loaded = self._load(self.version, self.encoder_device)
        if loaded is None:
            return None
        model, tok = loaded
        todo = [p for p in prompts if p not in self._cache]
        if todo:
            dev = next(model.parameters()).device
            enc = {k: v.to(dev) for k, v in tok(list(todo), padding=True,
                                                 return_tensors="pt").items()}
            with torch.no_grad():
                out = model(**enc).text_embeds.float().cpu().numpy()
            for i, p in enumerate(todo):
                self._cache[p] = out[i]
        return np.stack([self._cache[p] for p in prompts])

    def _embed_one(self, text: str) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
        v = np.random.default_rng(seed).normal(size=self.embedding_dim).astype(np.float32)
        return v / np.linalg.norm(v)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if "text_prompts" not in context or "clap_embeddings" in context:
            return context
        prompts = list(context["text_prompts"])
        emb = self._embed_real(prompts)
        if emb is None:
            emb = np.stack([self._embed_one(t) for t in prompts])
        new_context = dict(context)
        new_context["clap_embeddings"] = torch.from_numpy(emb)
        return new_context
