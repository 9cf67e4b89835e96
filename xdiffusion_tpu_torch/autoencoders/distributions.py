"""Diagonal Gaussian posterior.

Counterpart of xdiffusion_tpu/autoencoders/distributions.py. Channel-last:
the moments are (..., 2 C), mean then log-variance on the trailing axis; the
log-variance is clipped to [-30, 20]. `sample` takes its standard-normal
draw as `noise`, or draws it from `generator`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class DiagonalGaussianDistribution:
    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)
        if deterministic:
            self.std = torch.zeros_like(self.mean)
            self.var = torch.zeros_like(self.mean)

    def sample(self, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                                device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((self.mean.shape[0],), device=self.mean.device)
        axes = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=axes)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=axes)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((sample.shape[0],), device=sample.device)
        axes = tuple(range(1, sample.ndim))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=axes)


def moments_to_distribution(moments: torch.Tensor, latent_channels: int
                            ) -> DiagonalGaussianDistribution:
    """The posterior of moments (..., latent_channels + 1 or 2 C): one
    log-variance channel broadcasts over the latent channels
    (xdiffusion_tpu/autoencoders/causal_video.py `_moments_to_distribution`)."""
    mean = moments[..., :latent_channels]
    logvar = moments[..., latent_channels:]
    if logvar.shape[-1] == 1:
        logvar = logvar.expand(mean.shape)
    return DiagonalGaussianDistribution(torch.cat([mean, logvar], dim=-1))
