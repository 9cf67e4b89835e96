"""Tensor helpers and device selection.

Counterpart of the helpers of xdiffusion_tpu/utils.py that the sampling
and training paths use, and flax's dropout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as given, else the CUDA device. Raises when none is asked for
    and there is no CUDA device: the port never falls back to the CPU on
    its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


def extract(a: torch.Tensor, t: torch.Tensor, x_shape: Sequence[int]) -> torch.Tensor:
    """a[t] for a (T,) table and (B,) timesteps, shaped (B, 1, 1, ...)."""
    return a[t].reshape(t.shape[0], *((1,) * (len(x_shape) - 1)))


def broadcast_from_left(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """x broadcast against `shape` with singleton dims appended on the right."""
    extra = len(shape) - x.ndim
    if extra < 0:
        raise ValueError(f"cannot broadcast {tuple(x.shape)} to {tuple(shape)}")
    return x.reshape(*x.shape, *((1,) * extra)).expand(*shape)


def normalize_to_neg_one_to_one(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 - 1.0


def unnormalize_to_zero_to_one(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)


def dynamic_thresholding(x: torch.Tensor, p: float = 0.995, c: float = 1.7) -> torch.Tensor:
    """Imagen dynamic thresholding of a predicted x0 batch."""
    b = x.shape[0]
    s = torch.quantile(x.reshape(b, -1).abs().float(), p, dim=-1)
    s = s.clamp(1.0, c).reshape(b, *((1,) * (x.ndim - 1))).to(x.dtype)
    return torch.clamp(x, -s, s) / s


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions: (B, ...) -> (B,)."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


def prob_mask_like(shape, prob: float, generator: torch.Generator,
                   device: Union[str, torch.device]) -> torch.Tensor:
    """Boolean mask, each element True with probability `prob`."""
    if prob == 1.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if prob == 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.rand(shape, generator=generator, device=device) < prob


def dropout_mask(shape, keep: float, generator: torch.Generator,
                 device: Union[str, torch.device]) -> torch.Tensor:
    """Boolean keep-mask, each element True with probability `keep`."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dropout`: zero with probability `rate`, scale the kept values
    by 1 / (1 - rate), in x's dtype. The mask comes from `generator` (on x's
    device); `F.dropout` takes no generator."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
