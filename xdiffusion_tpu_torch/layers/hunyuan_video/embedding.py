"""HunyuanVideo's rotary-table context head.

Counterpart of `RopeFrequencies` in
xdiffusion_tpu/layers/hunyuan_video/embedding.py: a host-side context head
that writes the (cos, sin) rotary tables of the (T', H', W') latent patch
grid, stacked, at context[context_output_key], (2, 1, T'H'W', head_dim //
2) fp32. As in the JAX package the score network reads other keys
(`rope_frequencies_cos` and `rope_frequencies_sin`) and recomputes the
tables itself, so these never reach it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from xdiffusion_tpu_torch.layers.flux import rope_frequencies


class RopeFrequencies:
    def __init__(self, context_output_key: str = "rope_frequencies", video_length: int = 29,
                 height: int = 64, width: int = 64, patch_size: Sequence[int] = (1, 2, 2),
                 rope_theta: float = 256.0, rope_dim_list: Sequence[int] = (16, 24, 24),
                 **kwargs):
        self.context_output_key = context_output_key
        self.grid = [max(1, int(video_length) // int(patch_size[0])),
                     int(height) // int(patch_size[1]), int(width) // int(patch_size[2])]
        self.theta = float(rope_theta)
        self.axes_dim = list(rope_dim_list)

    def __call__(self, context: Dict, **kwargs) -> Dict:
        if self.context_output_key in context:
            return context
        t, h, w = self.grid
        tt, hh, ww = torch.meshgrid(torch.arange(t), torch.arange(h), torch.arange(w),
                                    indexing="ij")
        ids = torch.stack([tt, hh, ww], dim=-1).reshape(1, t * h * w, 3)
        cos, sin = rope_frequencies(ids, self.axes_dim, self.theta)
        new_context = dict(context)
        new_context[self.context_output_key] = torch.stack([cos, sin])
        return new_context
