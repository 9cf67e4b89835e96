"""Predictor-corrector samplers of the score SDEs.

Counterpart of xdiffusion_tpu/samplers/pc.py: each step runs the
corrector's updates (Langevin, or none) and then one predictor update
(ancestral, Euler-Maruyama or reverse diffusion); the last step returns the
predictor's noise-free mean. Every update takes its standard-normal noise
from `draw()`, called once per draw in the JAX package's order (the
corrector's draws, then the predictor's), so a caller can inject the draws.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from xdiffusion_tpu_torch.config import instantiate_partial_from_config
from xdiffusion_tpu_torch.sde.vpsde import step_index
from xdiffusion_tpu_torch.utils import broadcast_from_left

Draw = Callable[[], torch.Tensor]


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


class Predictor:
    def __init__(self, sde, score_fn: Callable, probability_flow: bool = False):
        self.sde = sde
        self.score_fn = score_fn
        self.probability_flow = probability_flow

    def update(self, x: torch.Tensor, t: torch.Tensor, draw: Draw):
        """(x, x_mean) after one reverse step from time t."""
        raise NotImplementedError


class AncestralSamplingPredictor(Predictor):
    """DDPM's ancestral update in score form (VP SDEs)."""

    def update(self, x, t, draw):
        sde = self.sde
        beta = broadcast_from_left(
            sde._on("discrete_betas", x.device)[step_index(t, sde.N, sde.T)], x.shape)
        score = self.score_fn(x, t)
        x_mean = (x + beta * score) / torch.sqrt(1.0 - beta)
        return x_mean + torch.sqrt(beta) * draw(), x_mean


class EulerMaruyamaPredictor(Predictor):
    def update(self, x, t, draw):
        sde = self.sde
        dt = -sde.T / sde.N
        drift, diffusion = sde.sde(x, t)
        score = self.score_fn(x, t)
        g2 = broadcast_from_left(diffusion ** 2, x.shape)
        coef = 0.5 if self.probability_flow else 1.0
        x_mean = x + (drift - g2 * score * coef) * dt
        if self.probability_flow:
            return x_mean, x_mean
        noise = broadcast_from_left(diffusion, x.shape) * torch.sqrt(_f32(-dt, x)) * draw()
        return x_mean + noise, x_mean


class ReverseDiffusionPredictor(Predictor):
    def update(self, x, t, draw):
        f, g = self.sde.discretize(x, t)
        score = self.score_fn(x, t)
        g_b = broadcast_from_left(g, x.shape)
        coef = 0.5 if self.probability_flow else 1.0
        x_mean = x - (f - g_b ** 2 * score * coef)
        if self.probability_flow:
            return x_mean, x_mean
        return x_mean + g_b * draw(), x_mean


class LangevinCorrector:
    def __init__(self, sde, score_fn: Callable, snr: float = 0.16, n_steps: int = 1):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = float(snr)
        self.n_steps = int(n_steps)

    def update(self, x, t, draw):
        sde = self.sde
        if hasattr(sde, "alphas"):
            alpha = sde._on("alphas", x.device)[step_index(t, sde.N, sde.T)]
        else:
            alpha = torch.ones_like(t)
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t)
            noise = draw()
            grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
            noise_norm = torch.linalg.norm(noise.reshape(noise.shape[0], -1), dim=-1).mean()
            step_size = (self.snr * noise_norm / grad_norm) ** 2 * 2.0 * alpha
            ss = broadcast_from_left(step_size, x.shape)
            x_mean = x + ss * grad
            x = x_mean + torch.sqrt(ss * 2.0) * noise
        return x, x_mean


class NoneCorrector:
    def __init__(self, **kwargs):
        pass

    def update(self, x, t, draw):
        return x, x


class PredictorCorrectorSampler:
    """The config's predictor and corrector, one step at a time."""

    def __init__(self, predictor: Dict, corrector: Dict, **kwargs):
        self._predictor_cfg = predictor
        self._corrector_cfg = corrector

    def build(self, sde, score_fn: Callable) -> Callable:
        """`step(x, t, denoise_final, draw)` -> x after one PC step at time t
        (B,); the predictor's mean on the final step."""
        predictor = instantiate_partial_from_config(self._predictor_cfg)(sde=sde,
                                                                         score_fn=score_fn)
        corrector = instantiate_partial_from_config(self._corrector_cfg)(sde=sde,
                                                                         score_fn=score_fn)

        def step(x, t, denoise_final: bool, draw: Draw):
            x, _ = corrector.update(x, t, draw)
            x, x_mean = predictor.update(x, t, draw)
            return x_mean if denoise_final else x

        return step
