"""HunyuanVideo: the dual-stream, then single-stream video transformer.

Counterpart of `SingleTokenRefiner` and `HYVideoDiffusionTransformer` in
xdiffusion_tpu/score_networks/hunyuan_video.py: 3-D patchified video
latents and the refined text tokens run through `mm_double_blocks_depth`
double-stream blocks (separate weights, one joint attention over [text;
video]) and `mm_single_blocks_depth` single-stream blocks, the Flux blocks
of layers/flux.py, with 3-axis RoPE over (frame, row, col) video ids and
all-zero text ids (the text tokens' rotation is the identity). The
conditioning vector is the time embedding (the cos-first GLIDE sinusoid of
the raw timestep) plus the projected pooled CLIP embedding. The output
unpatchifies channel-first, unlike Sora's.

The token refiner (`txt_refiner`) projects the text states and runs two
adaLN-gated transformer layers whose conditioning is the time embedding
plus a projection of the (mask-weighted) mean of the raw text states. With
a text mask (`use_attention_mask`, the default, and a mask in the context)
its attention runs plain einsums with a -inf bias whose first column is
forced open, as the JAX package does; without one it goes to K5. The hash
T5 embedder gives no mask, so at hunyuan_video.yaml's size and batch 8 the
refiner's calls are (8, 6, 256, 256) and the blocks' joint calls (8, 6,
400, 400) (256 text + 144 video tokens): 20 K5 launches a forward, their
gradients on K6.

The context keys are the JAX package's, with its aliases:
`clip_text_embeddings` or `hv_clip_embeddings`, `text_embeddings` or
`hv_llm_embeddings`, `text_attention_mask` or
`hv_llm_embeddings_attention_mask`. Precomputed rotary tables are read from
`rope_frequencies_cos` and `rope_frequencies_sin` ((N_video, head_dim),
interleave-doubled), not from the key the `RopeFrequencies` head writes
(layers/hunyuan_video/embedding.py), as in JAX. The widths of the text
inputs come from the config's `text_states_dim` and `clip_states_dim`
(flax infers them from the first call). `guidance_embed`, `qk_norm`,
`qk_norm_type` and `text_projection` are read by neither package: the
blocks always take the RMS qk-norm.

Submodules carry the names of the JAX package's flax parameter paths
(`img_in`, `time_in`, `vector_in`, `txt_refiner/{t_fc1, t_fc2, c_fc1,
c_fc2, input_embedder, adaLN_i, norm1_i, qkv_i, proj_i, norm2_i, mlp1_i,
mlp2_i}`, `double_{i}`, `single_{i}`, `final`), so the weight bridge
(weights.py) maps a flax tree onto this module mechanically. Every layer
computes in fp32, as the JAX modules do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import glide_timestep_embedding
from xdiffusion_tpu_torch.layers.flux import (
    DoubleStreamBlock,
    LastLayer,
    MLPEmbedder,
    SingleStreamBlock,
    heads,
    rope_frequencies,
)
from xdiffusion_tpu_torch.layers.linear import Dense
from xdiffusion_tpu_torch.layers.norm import LayerNorm
from xdiffusion_tpu_torch.ops.attention import dot_product_attention


class SingleTokenRefiner(nn.Module):
    """The text states (B, L, text_dim) -> (B, L, hidden) refined tokens,
    conditioned on the raw timesteps (B,) and, with a mask (B, L) (1: a
    real token), on the masked mean of the states."""

    def __init__(self, text_dim: int, hidden_size: int, num_heads: int, depth: int = 2):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.depth = depth
        self.t_fc1 = Dense(256, d)
        self.t_fc2 = Dense(d, d)
        self.c_fc1 = Dense(text_dim, d)
        self.c_fc2 = Dense(d, d)
        self.input_embedder = Dense(text_dim, d)
        for i in range(depth):
            self.add_module(f"adaLN_{i}", Dense(d, 2 * d, zero_init=True))
            self.add_module(f"norm1_{i}", LayerNorm(d))
            self.add_module(f"qkv_{i}", Dense(d, 3 * d))
            self.add_module(f"proj_{i}", Dense(d, d))
            self.add_module(f"norm2_{i}", LayerNorm(d))
            self.add_module(f"mlp1_{i}", Dense(d, 4 * d))
            self.add_module(f"mlp2_{i}", Dense(4 * d, d))

    def forward(self, text_states: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, length, _ = text_states.shape
        temb = self.t_fc2(F.silu(self.t_fc1(glide_timestep_embedding(t.float(), 256))))
        if mask is None:
            ctx = text_states.mean(dim=1)
        else:
            mf = mask.float()[:, :, None]
            ctx = (text_states * mf).sum(dim=1) / (mf.sum(dim=1) + 1e-8)
        c = temb + self.c_fc2(F.silu(self.c_fc1(ctx)))

        attn_bias = None
        if mask is not None:
            valid = mask.bool()
            keep = valid[:, :, None] & valid[:, None, :]  # (B, L, L)
            keep[:, :, 0] = True  # fully padded rows do not NaN
            attn_bias = torch.where(keep[:, None], 0.0, float("-inf"))

        x = self.input_embedder(text_states)
        hd = x.shape[-1] // self.num_heads
        for i in range(self.depth):
            g1, g2 = getattr(self, f"adaLN_{i}")(F.silu(c)).chunk(2, dim=-1)
            h = getattr(self, f"norm1_{i}")(x)
            q, k, v = (heads(t_, self.num_heads)
                       for t_ in getattr(self, f"qkv_{i}")(h).chunk(3, dim=-1))
            if attn_bias is not None:
                logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (hd ** -0.5)
                w = torch.softmax(logits + attn_bias, dim=-1)
                attn = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
            else:
                attn = dot_product_attention(q, k, v)
            attn = attn.transpose(1, 2).reshape(b, length, -1)
            x = x + g1[:, None] * getattr(self, f"proj_{i}")(attn)
            h = getattr(self, f"norm2_{i}")(x)
            h = getattr(self, f"mlp2_{i}")(F.silu(getattr(self, f"mlp1_{i}")(h)))
            x = x + g2[:, None] * h
        return x


class HYVideoDiffusionTransformer(nn.Module):
    """Built from the score_network params block as a DotConfig."""

    def __init__(self, config: Any):
        super().__init__()
        cfg = config
        self._config = cfg
        d = int(cfg.hidden_size)
        self._num_heads = int(cfg.heads_num)
        self._patch = tuple(int(p) for p in cfg.patch_size)  # (pt, ph, pw)
        self._rope_dims = tuple(int(r) for r in cfg.rope_dim_list)
        if sum(self._rope_dims) != d // self._num_heads:
            raise ValueError(f"rope_dim_list {self._rope_dims} must sum to the head dim "
                             f"{d // self._num_heads}")
        self._is_learned_sigma = bool(cfg.get("is_learned_sigma", False))
        self._out_channels = int(cfg.out_channels) * (2 if self._is_learned_sigma else 1)
        pt, ph, pw = self._patch
        self.img_in = Dense(int(cfg.in_channels) * pt * ph * pw, d)
        self.time_in = MLPEmbedder(256, d)
        self.vector_in = MLPEmbedder(int(cfg.get("clip_states_dim", 768)), d)
        self.txt_refiner = SingleTokenRefiner(int(cfg.get("text_states_dim", 4096)), d,
                                              self._num_heads, depth=2)
        self._use_attention_mask = bool(cfg.get("use_attention_mask", True))
        mlp_ratio = float(cfg.get("mlp_width_ratio", 4.0))
        self._double_blocks = []
        for i in range(int(cfg.mm_double_blocks_depth)):
            block = DoubleStreamBlock(d, self._num_heads, mlp_ratio=mlp_ratio,
                                      qkv_bias=bool(cfg.get("qkv_bias", True)))
            self.add_module(f"double_{i}", block)
            self._double_blocks.append(block)
        self._single_blocks = []
        for i in range(int(cfg.mm_single_blocks_depth)):
            block = SingleStreamBlock(d, self._num_heads, mlp_ratio=mlp_ratio)
            self.add_module(f"single_{i}", block)
            self._single_blocks.append(block)
        self.final = LastLayer(d, pt * ph * pw * self._out_channels)

    def _rope(self, b: int, n_txt: int, gf: int, gh: int, gw: int, context: Dict,
              device) -> tuple:
        rope_cos = context.get("rope_frequencies_cos")
        if rope_cos is not None:
            # Precomputed video tables (N_video, head_dim), interleave-doubled;
            # the text tokens take the identity rotation.
            img_cos = torch.as_tensor(rope_cos, device=device)[..., 0::2]
            img_sin = torch.as_tensor(context["rope_frequencies_sin"], device=device)[..., 0::2]
            cos = torch.cat([torch.ones((n_txt, img_cos.shape[-1]), dtype=img_cos.dtype,
                                        device=device), img_cos])[None]
            sin = torch.cat([torch.zeros((n_txt, img_sin.shape[-1]), dtype=img_sin.dtype,
                                         device=device), img_sin])[None]
            return cos.expand(b, *cos.shape[1:]), sin.expand(b, *sin.shape[1:])
        fi = torch.arange(gf, device=device).repeat_interleave(gh * gw)
        ri = torch.arange(gh, device=device).repeat_interleave(gw).repeat(gf)
        ci = torch.arange(gw, device=device).repeat(gf * gh)
        img_ids = torch.stack([fi, ri, ci], dim=-1).float()[None].expand(b, -1, 3)
        ids = torch.cat([torch.zeros((b, n_txt, 3), device=device), img_ids], dim=1)
        return rope_frequencies(ids, self._rope_dims,
                                float(self._config.get("rope_theta", 256.0)))

    def forward(self, x: torch.Tensor, context: Dict):
        """x: (B, F, H, W, C) latent grid -> (B, F, H, W, C out) fp32, or the
        pair (prediction, log-variance) of a learned-sigma network."""
        b, f, hh, ww, c = x.shape
        pt, ph, pw = self._patch
        gf, gh, gw = f // pt, hh // ph, ww // pw
        img = x.reshape(b, gf, pt, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        img = self.img_in(img.reshape(b, gf * gh * gw, c * pt * ph * pw))

        timestep = context["timestep"].float()
        vec = self.time_in(glide_timestep_embedding(timestep, 256))
        clip_pooled = context.get("clip_text_embeddings", context.get("hv_clip_embeddings"))
        if clip_pooled is not None:
            vec = vec + self.vector_in(clip_pooled)
        text_states = context.get("text_embeddings", context.get("hv_llm_embeddings"))
        text_mask = context.get("text_attention_mask",
                                context.get("hv_llm_embeddings_attention_mask"))
        txt = self.txt_refiner(text_states, timestep,
                               text_mask if self._use_attention_mask else None)
        cos, sin = self._rope(b, txt.shape[1], gf, gh, gw, context, x.device)

        for block in self._double_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        merged = torch.cat([txt, img], dim=1)
        for block in self._single_blocks:
            merged = block(merged, vec, cos, sin)
        img = self.final(merged[:, txt.shape[1]:], vec)

        oc = self._out_channels
        out = img.reshape(b, gf, gh, gw, oc, pt, ph, pw).permute(0, 1, 5, 2, 6, 3, 7, 4)
        out = out.reshape(b, f, hh, ww, oc).float()
        if self._is_learned_sigma:
            return tuple(out.chunk(2, dim=-1))
        return out
