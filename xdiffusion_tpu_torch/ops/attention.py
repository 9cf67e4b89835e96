"""Multi-head attention dispatch.

Counterpart of `attention_qkv`, `attention_bshd` and
`dot_product_attention` in xdiffusion_tpu/ops/attention.py.

- `attention_qkv` (the (B, S, C=H*D) projection layout): every non-causal
  call goes to K1 (ops/flash_attention.short_attention_bsc), which launches
  its kernel on CUDA tensors and runs the plain `attention_bshd` on CPU
  tensors; its gradient goes to K2. The TPU's row-count gate is not
  carried over.
- `dot_product_attention` ((B, H, S, D)): every non-causal call goes to K5
  (ops/flash_attention.flash_attention), which launches its kernel on CUDA
  tensors and runs its plain version (the arithmetic of the JAX package's
  `_xla_attention`) on CPU tensors; its gradient goes to K6, from the
  output and logsumexp K5 saves, or K6's plain version on CPU tensors. On
  the CPU the JAX package differentiates `_xla_attention` with XLA; the two
  gradients agree to fp32 rounding. The TPU gate (`_flash_eligible`:
  S >= 1024, head dim a multiple of 64, S divisible by the 256/512 blocks)
  is not carried over. It kept short sequences on XLA because there the
  TPU kernel's block bookkeeping cost more than it saved, and its blocks
  must divide S. K5 takes any Sq and Sk, and one launch replaces the plain
  path's chain of products, softmax and casts without an (Sq, Sk) logits
  tensor in device memory; on the H100 it is faster than the plain path at
  every LTX site shape, 512 tokens included (chip_smoke.py, phase 7). So
  the port has no gate.

Causal calls on CUDA tensors raise in both: no kernel takes them yet.
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


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          is_causal: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, S, D) tensors; returns
    (B, H, Sq, D)."""
    from xdiffusion_tpu_torch.ops.flash_attention import flash_attention

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not is_causal:
        return flash_attention(q, k, v, scale)[0]
    if q.device.type != "cpu":
        raise NotImplementedError("causal attention has no kernel in the port yet")
    heads_last = [t.transpose(1, 2) for t in (q, k, v)]
    return attention_bshd(*heads_last, scale=scale, is_causal=True).transpose(1, 2)
