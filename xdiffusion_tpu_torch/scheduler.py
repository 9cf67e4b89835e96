"""The discrete (DDPM) forward-process noise scheduler.

Counterpart of `DiscreteNoiseScheduler` in xdiffusion_tpu/scheduler.py:
the beta schedule and every derived table are built in float64 numpy and
stored as float32, exactly as the JAX package builds them. Per-timestep
lookups gather from the tables on the tables' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Dict, Tuple

import numpy as np
import torch

from xdiffusion_tpu_torch.utils import extract


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1.0 - (ac[1:] / ac[:-1]), 0.0, 0.999)


def linear_beta_schedule(timesteps: int, min_beta: float = 1e-4,
                         max_beta: float = 0.02) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * min_beta, scale * max_beta, timesteps, dtype=np.float64)


def quadratic_beta_schedule(timesteps: int, min_beta: float = 1e-4,
                            max_beta: float = 0.02) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace((scale * min_beta) ** 0.5, (scale * max_beta) ** 0.5,
                       timesteps, dtype=np.float64) ** 2


def sigmoid_beta_schedule(timesteps: int, min_beta: float = 1e-4,
                          max_beta: float = 0.02) -> np.ndarray:
    scale = 1000.0 / timesteps
    start, end = scale * min_beta, scale * max_beta
    x = np.linspace(-6, 6, timesteps, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x)) * (end - start) + start


def jsd_beta_schedule(timesteps: int) -> np.ndarray:
    return 1.0 / np.linspace(timesteps, 1, timesteps, dtype=np.float64)


def make_beta_schedule(schedule_type: str, timesteps: int, min_beta: float = 1e-4,
                       max_beta: float = 0.02) -> np.ndarray:
    if schedule_type == "cosine":
        return cosine_beta_schedule(timesteps)
    if schedule_type == "linear":
        return linear_beta_schedule(timesteps, min_beta, max_beta)
    if schedule_type == "quadratic":
        return quadratic_beta_schedule(timesteps, min_beta, max_beta)
    if schedule_type == "sigmoid":
        return sigmoid_beta_schedule(timesteps, min_beta, max_beta)
    if schedule_type == "jsd":
        return jsd_beta_schedule(timesteps)
    raise NotImplementedError(f"Noise schedule {schedule_type} not implemented.")


@dataclass(frozen=True, eq=False)
class DiscreteNoiseScheduler:
    """DDPM discrete-time q(x_t | x_0), its posterior and the tables the
    samplers read. Tables are (num_timesteps,) float32 tensors."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    num_timesteps: int
    loss_type: str = "l2"

    @classmethod
    def create(cls, schedule_type: str = "linear", num_scales: int = 1000,
               loss_type: str = "l2", min_beta: float = 1e-4, max_beta: float = 0.02,
               **_ignored) -> "DiscreteNoiseScheduler":
        betas = make_beta_schedule(schedule_type, num_scales, min_beta, max_beta)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas, axis=0)
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        fixed_large = np.concatenate([[post_var[1]], betas[1:]])

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32))

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
            fixed_large_log_variance=f32(np.log(fixed_large)),
            num_timesteps=int(num_scales),
            loss_type=loss_type,
        )

    def to(self, device) -> "DiscreteNoiseScheduler":
        """A copy with every table on `device`."""
        return replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in fields(self) if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def steps(self) -> int:
        return self.num_timesteps

    def continuous(self) -> bool:
        return False

    def q_posterior(self, x_start, x_t, context: Dict) -> Tuple[torch.Tensor, ...]:
        t = context["timestep"]
        mean = (extract(self.posterior_mean_coef1, t, x_t.shape) * x_start
                + extract(self.posterior_mean_coef2, t, x_t.shape) * x_t)
        variance = extract(self.posterior_variance, t, x_t.shape)
        log_variance = extract(self.posterior_log_variance_clipped, t, x_t.shape)
        return mean, variance, log_variance

    def variance_fixed_large(self, context: Dict, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        t = context["timestep"]
        return extract(self.betas, t, shape), extract(self.fixed_large_log_variance, t, shape)

    def predict_x_from_epsilon(self, z, epsilon, context: Dict):
        t = context["timestep"]
        return (extract(self.sqrt_recip_alphas_cumprod, t, z.shape) * z
                - extract(self.sqrt_recipm1_alphas_cumprod, t, z.shape) * epsilon)

    def predict_x_from_v(self, z, v, context: Dict):
        t = context["timestep"]
        alpha_t = extract(self.sqrt_alphas_cumprod, t, z.shape)
        sigma_t = extract(self.sqrt_one_minus_alphas_cumprod, t, z.shape)
        return alpha_t * z - sigma_t * v

    def predict_epsilon_from_x(self, z, x, context: Dict):
        t = context["timestep"]
        alpha_t = extract(self.sqrt_alphas_cumprod, t, x.shape)
        sigma_t = extract(self.sqrt_one_minus_alphas_cumprod, t, x.shape)
        return (z - alpha_t * x) / sigma_t

    def logsnr_from_index(self, t: torch.Tensor) -> torch.Tensor:
        """log(alpha_bar / (1 - alpha_bar)) at integer t (fp32)."""
        ac = self.alphas_cumprod[t.clamp(0, self.num_timesteps - 1)]
        return torch.log(ac) - torch.log1p(-ac)


def discrete_noise_scheduler(**kwargs) -> DiscreteNoiseScheduler:
    """Config factory: the importance_sampler sub-block is for the process."""
    kwargs.pop("importance_sampler", None)
    return DiscreteNoiseScheduler.create(**kwargs)
