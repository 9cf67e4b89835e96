"""Conditioning-context adapters the image configs name.

Counterpart of `Identity`, `IgnoreContextAdapter` and
`IgnoreInputPreprocessor` in xdiffusion_tpu/context.py.
"""

from __future__ import annotations

from typing import Dict


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
