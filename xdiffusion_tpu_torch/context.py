"""Conditioning-context adapters the ported configs name.

Counterpart of `Identity`, `IgnoreContextAdapter`, `IgnoreInputPreprocessor`,
`UnconditionalClassesAdapter` and `UnconditionalTextPromptsAdapter` in
xdiffusion_tpu/context.py.
"""

from __future__ import annotations

from typing import Dict

import torch


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
    already in the context (the empty prompt's stand-in)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, context: Dict, **kwargs) -> Dict:
        new_context = dict(context)
        if "text_prompts" in context:
            new_context["text_prompts"] = [""] * len(context["text_prompts"])
        for key in ("text_tokens", "text_embeddings", "t5_text_embeddings",
                    "clip_text_embeddings"):
            if isinstance(context.get(key), torch.Tensor):
                new_context[key] = torch.zeros_like(context[key])
        return new_context
