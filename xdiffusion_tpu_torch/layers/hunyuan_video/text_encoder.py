"""HunyuanVideo's text encoders, on their offline path.

Counterpart of `TextEncoder` in
xdiffusion_tpu/layers/hunyuan_video/text_encoder.py, which has only the
hash path: the LLaVA-LLaMA states (`llava_llm`, (B, max_length, 4096)) or
CLIP-L's pooled state (`clipL`, (B, 768)) as the sha256-seeded hash
embedding of each prompt (layers/embedding.py `_HashEmbedFallback`),
bit-equal to the JAX package's, fp32 on the CPU (the diffusion process
moves them to its device).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from xdiffusion_tpu_torch.layers.embedding import _HashEmbedFallback

_TYPE_DIMS = {"llava_llm": 4096, "clipL": 768}


class TextEncoder:
    host_side = True

    def __init__(self, model: str = "", text_encoder_type: str = "llava_llm",
                 max_length: int = 256, hidden_state_skip_layer: int = 2,
                 prompt_template: Optional[str] = None,
                 prompt_template_video: Optional[str] = None,
                 context_input_key: str = "text_prompts",
                 context_output_key: Optional[str] = None,
                 embedding_dim: Optional[int] = None, **kwargs):
        self.encoder_type = text_encoder_type
        self.pooled = text_encoder_type == "clipL"
        self.input_key = context_input_key
        self.output_key = context_output_key or (
            "clip_text_embeddings" if self.pooled else "text_embeddings")
        dim = int(embedding_dim or _TYPE_DIMS.get(text_encoder_type, 768))
        self._fallback = _HashEmbedFallback(1 if self.pooled else int(max_length), dim)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if self.input_key not in context or self.output_key in context:
            return context
        emb = np.stack([self._fallback(t) for t in context[self.input_key]])
        if self.pooled:
            emb = emb[:, 0]
        new_context = dict(context)
        new_context[self.output_key] = torch.from_numpy(emb)
        return new_context
