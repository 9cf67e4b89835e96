"""The SDE protocol and the reverse-time SDE.

Counterpart of xdiffusion_tpu/sde/base.py: an SDE is a small object whose
drift, diffusion and marginal statistics are functions of tensors;
`reverse(score_fn)` builds the reverse-time SDE (or, with
`probability_flow`, the probability-flow ODE) around a score function.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


class SDE:
    """Forward-time SDE dx = f(x, t) dt + g(t) dW on t in [0, T], discretized
    into N steps."""

    def __init__(self, N: int = 1000, T: float = 1.0):
        self.N = int(N)
        self.T = float(T)

    def sde(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(drift, diffusion)."""
        raise NotImplementedError

    def marginal_prob(self, x: torch.Tensor, t: torch.Tensor):
        """(mean, std) of p_t(x(t) | x(0))."""
        raise NotImplementedError

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def discretize(self, x: torch.Tensor, t: torch.Tensor):
        """Euler-Maruyama: (drift * dt, diffusion * sqrt(dt)), dt = T / N."""
        dt = self.T / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * (dt ** 0.5)

    def sigma_t(self, t) -> torch.Tensor:
        raise NotImplementedError

    def noise_scale(self) -> float:
        return 1.0

    def reverse(self, score_fn: Callable, probability_flow: bool = False) -> "ReverseSDE":
        """score_fn(x, t) -> grad_x log p_t(x)."""
        return ReverseSDE(self, score_fn, probability_flow)


def _bcast(coeff: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-batch coefficient left-aligned against a data tensor."""
    coeff = torch.as_tensor(coeff)
    return coeff.reshape(coeff.shape + (1,) * (like.ndim - coeff.ndim))


class ReverseSDE(SDE):
    """dx = [f(x, t) - g(t)^2 score(x, t)] dt + g(t) dW-bar in reverse time;
    the probability-flow ODE halves the score term and has no diffusion."""

    def __init__(self, forward: SDE, score_fn: Callable, probability_flow: bool):
        super().__init__(N=forward.N, T=forward.T)
        self._forward = forward
        self._score_fn = score_fn
        self.probability_flow = bool(probability_flow)

    def sde(self, x, t):
        drift, diffusion = self._forward.sde(x, t)
        coeff = 0.5 if self.probability_flow else 1.0
        drift = drift - _bcast(diffusion, x) ** 2 * self._score_fn(x, t) * coeff
        if self.probability_flow:
            diffusion = torch.zeros_like(diffusion)
        return drift, diffusion

    def discretize(self, x, t):
        f, g = self._forward.discretize(x, t)
        coeff = 0.5 if self.probability_flow else 1.0
        rev_f = f - _bcast(g, x) ** 2 * self._score_fn(x, t) * coeff
        rev_g = torch.zeros_like(g) if self.probability_flow else g
        return rev_f, rev_g

    def marginal_prob(self, x, t):
        return self._forward.marginal_prob(x, t)

    def prior_logp(self, z):
        return self._forward.prior_logp(z)

    def sigma_t(self, t):
        return self._forward.sigma_t(t)

    def noise_scale(self) -> float:
        return self._forward.noise_scale()
