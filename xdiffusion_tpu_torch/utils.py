"""Tensor helpers and device selection.

Counterpart of the helpers of xdiffusion_tpu/utils.py that the sampling
and training paths use (the learned-sigma loss's Gaussian KL and
discretised likelihood among them), and flax's dropout.
"""

from __future__ import annotations

import math
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


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(-x)) for x > 0, stable at both ends (Maechler 2012)."""
    return torch.where(x > math.log(2.0), torch.log1p(-torch.exp(-x)),
                       torch.log(-torch.expm1(-x)))


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


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL divergence between two diagonal Gaussians, elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of x (uint8 data scaled to [-1, 1]) under a Gaussian
    discretised into 256 bins, elementwise. All three branches are computed
    and selected with `torch.where`, each log of a value clipped at 1e-12,
    so the branches not taken give no NaN gradients."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


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
