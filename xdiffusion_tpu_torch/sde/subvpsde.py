"""The sub-VP SDE (Score-SDE eq. 29).

Counterpart of xdiffusion_tpu/sde/subvpsde.py. The marginal std is
1 - exp(2 * log_mean_coeff), without a square root: that is the sub-VP
SDE's defining property, kept as the JAX package keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from xdiffusion_tpu_torch.sde.base import SDE
from xdiffusion_tpu_torch.sde.vpsde import _table, _Tables, prior_logp
from xdiffusion_tpu_torch.utils import broadcast_from_left


class subVPSDE(SDE, _Tables):
    def __init__(self, beta_min: float = 0.1, beta_max: float = 20.0, N: int = 1000,
                 **kwargs):
        super().__init__(N=N, T=1.0)
        self.beta_0 = float(beta_min)
        self.beta_1 = float(beta_max)
        betas = np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)
        self.discrete_betas = _table(betas)
        self.alphas = _table(1.0 - betas)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        drift = -0.5 * broadcast_from_left(beta_t, x.shape) * x
        discount = 1.0 - torch.exp(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t ** 2)
        return drift, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        log_mean_coeff = -0.25 * t ** 2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        mean = broadcast_from_left(torch.exp(log_mean_coeff), x.shape) * x
        return mean, 1.0 - torch.exp(2.0 * log_mean_coeff)

    def prior_sampling(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device)

    def prior_logp(self, z):
        return prior_logp(z)
