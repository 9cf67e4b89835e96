"""Chewie's double-stream block: PoolFormer token mixing in place of attention.

Counterpart of `pooling_token_mixer` and `ChewieDoubleStreamBlock` in
xdiffusion_tpu/layers/chewie.py (PoolFormer, arXiv:2111.11418): the
modulated text and image tokens, split into heads and RoPE-rotated, are
average-pooled over a (pool, pool) window and the pooled-minus-identity
result is projected back per stream. The blocks have no q, k or v and no
attention: they launch no kernel of the port.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.flux import Modulation, apply_norm, apply_rope, heads, make_norm
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.score_networks.dit import modulate


def pooling_token_mixer(x: torch.Tensor, pool_size: int = 3) -> torch.Tensor:
    """PoolFormer mixing on (B, H, L, D): the mean over a (pool, pool) window
    of the last two axes, stride 1, same padding, padded taps left out of
    the count, minus x. The window runs over tokens AND head channels, as in
    the JAX package and the reference it follows."""
    b, h, length, d = x.shape
    pooled = F.avg_pool2d(x.reshape(b * h, 1, length, d), pool_size, stride=1,
                          padding=pool_size // 2, count_include_pad=False)
    return pooled.reshape(x.shape) - x


class ChewieDoubleStreamBlock(nn.Module):
    """A Flux double-stream block whose joint attention is the pooling mixer
    over [text; image]; `qkv_bias` is taken for the config's sake and builds
    nothing, as in the JAX package."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float = 4.0,
                 pool_size: int = 3, qkv_bias: bool = False, norm_cls: str = "layernorm"):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.pool_size = pool_size
        mlp = int(d * mlp_ratio)
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", Modulation(d, double=True))
            self.add_module(f"{s}_norm1", make_norm(norm_cls, d))
            self.add_module(f"{s}_proj", Dense(d, d))
            self.add_module(f"{s}_norm2", make_norm(norm_cls, d))
            self.add_module(f"{s}_mlp1", Dense(d, mlp))
            self.add_module(f"{s}_mlp2", Dense(mlp, d))

    def _residual(self, s: str, x, mixed, gate1, shift2, scale2, gate2):
        x = x + gate1[:, None] * getattr(self, f"{s}_proj")(mixed)
        h = modulate(apply_norm(getattr(self, f"{s}_norm2"), x), shift2, scale2)
        h = getattr(self, f"{s}_mlp2")(F.gelu(getattr(self, f"{s}_mlp1")(h), approximate="tanh"))
        return x + gate2[:, None] * h

    def forward(self, img, txt, vec, cos, sin):
        b, n_img, d = img.shape
        n_txt = txt.shape[1]
        im1, is1, ig1, im2, is2, ig2 = self.img_mod(vec)
        tm1, ts1, tg1, tm2, ts2, tg2 = self.txt_mod(vec)
        img_n = modulate(apply_norm(self.img_norm1, img), im1, is1)
        txt_n = modulate(apply_norm(self.txt_norm1, txt), tm1, ts1)
        merged = torch.cat([heads(txt_n, self.num_heads), heads(img_n, self.num_heads)], dim=2)
        mixed = pooling_token_mixer(apply_rope(merged, cos, sin), self.pool_size)
        mixed = mixed.transpose(1, 2).reshape(b, n_txt + n_img, d)
        img = self._residual("img", img, mixed[:, n_txt:], ig1, im2, is2, ig2)
        txt = self._residual("txt", txt, mixed[:, :n_txt], tg1, tm2, ts2, tg2)
        return img, txt
