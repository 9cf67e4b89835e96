"""Chewie: the Flux skeleton with pooling double-stream blocks.

Counterpart of `Chewie` in xdiffusion_tpu/score_networks/chewie.py: Flux's
patchify, T5 text stream, CLIP vector, 3-axis RoPE and last layer
(score_networks/flux.py), the double-stream blocks swapped for Chewie's
PoolFormer blocks (layers/chewie.py, no attention), then Flux's own
single-stream blocks, whose attention runs on K5 on the card (its gradient
on K6). Chewie has no guidance embedding.
"""

from __future__ import annotations

from typing import Any

from xdiffusion_tpu_torch.layers.chewie import ChewieDoubleStreamBlock
from xdiffusion_tpu_torch.score_networks.flux import FluxSkeleton


class Chewie(FluxSkeleton):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__(config)
        for i in range(int(config.depth)):
            self._add_double(i, ChewieDoubleStreamBlock(
                int(config.hidden_size), self._num_heads, mlp_ratio=float(config.mlp_ratio),
                pool_size=int(config.get("pool_size", 3)),
                qkv_bias=bool(config.get("qkv_bias", False))))
