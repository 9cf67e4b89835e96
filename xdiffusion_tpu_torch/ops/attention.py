"""Multi-head attention dispatch.

Counterpart of `attention_qkv` and `attention_bshd` in
xdiffusion_tpu/ops/attention.py. Every non-causal call goes to K1
(ops/flash_attention.short_attention_bsc), which launches its kernel on
CUDA tensors and runs the plain `attention_bshd` on CPU tensors. The TPU's
row-count gate is not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_bshd(q, k, v, scale: Optional[float] = None, is_causal: bool = False):
    """Attention over (B, S, H, D) tensors; returns (B, Sq, H, D).

    Logits and softmax in fp32; the weights are rounded to v's dtype before
    the PV product, which accumulates in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(v.dtype)


def attention_qkv(q, k, v, heads: int, is_causal: bool = False) -> torch.Tensor:
    """Multi-head attention on (B, S, C=heads*head_dim) projections."""
    from xdiffusion_tpu_torch.ops.flash_attention import short_attention_bsc

    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // heads
    if not is_causal:
        return short_attention_bsc(q, k, v, heads, d**-0.5)
    if q.device.type != "cpu":
        raise NotImplementedError("causal attention has no kernel in the port yet")
    out = attention_bshd(
        q.reshape(b, sq, heads, d), k.reshape(b, sk, heads, d),
        v.reshape(b, sk, heads, d), scale=d**-0.5, is_causal=True,
    )
    return out.reshape(b, sq, c)
