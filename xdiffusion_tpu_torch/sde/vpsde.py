"""The variance-preserving SDE (Score-SDE eq. 11).

Counterpart of xdiffusion_tpu/sde/vpsde.py: the discrete tables are built in
float64 numpy and kept in fp32, as the JAX package keeps them; they move to
a tensor's device at first use there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xdiffusion_tpu_torch.sde.base import SDE
from xdiffusion_tpu_torch.utils import broadcast_from_left


def _table(values: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=np.float32))


def step_index(t: torch.Tensor, n: int, total: float) -> torch.Tensor:
    """The discrete step of continuous times t: int32(fp32(t) * (N - 1) / T),
    taken in fp32 as the JAX package takes it."""
    return (t.float() * (n - 1) / total).to(torch.int32).long()


def prior_logp(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) per example."""
    n = int(np.prod(z.shape[1:]))
    return -n / 2.0 * math.log(2 * math.pi) - z.reshape(z.shape[0], -1).square().sum(-1) / 2.0


class _Tables:
    """Lazily device-placed copies of fp32 tables."""

    def _on(self, name: str, device) -> torch.Tensor:
        table = getattr(self, name)
        if table.device != torch.device(device):
            table = table.to(device)
            setattr(self, name, table)
        return table


class VPSDE(SDE, _Tables):
    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000,
                 T: float = 1.0, **kwargs):
        super().__init__(N=N, T=T)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        betas = np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        self.discrete_betas = _table(betas)
        self.alphas = _table(alphas)
        self.sqrt_alphas_cumprod = _table(np.sqrt(ac))
        self.sqrt_1m_alphas_cumprod = _table(np.sqrt(1.0 - ac))

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        drift = -0.5 * broadcast_from_left(beta_t, x.shape) * x
        return drift, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        log_mean_coeff = -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        mean = broadcast_from_left(torch.exp(log_mean_coeff), x.shape) * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
        return mean, std

    def prior_sampling(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z):
        return prior_logp(z)

    def discretize(self, x, t):
        """DDPM's discretization: f = (sqrt(alpha) - 1) x, G = sqrt(beta)."""
        i = step_index(t, self.N, self.T)
        beta = self._on("discrete_betas", x.device)[i]
        alpha = self._on("alphas", x.device)[i]
        f = broadcast_from_left(torch.sqrt(alpha), x.shape) * x - x
        return f, torch.sqrt(beta)
