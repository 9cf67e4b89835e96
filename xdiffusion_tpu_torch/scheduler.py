"""The discrete (DDPM), continuous-time (logSNR) and rectified-flow
forward-process noise schedulers and the training losses.

Counterpart of `DiscreteNoiseScheduler`, `ContinuousNoiseScheduler`,
`DiscreteRectifiedFlowNoiseScheduler`, the logSNR schedules and
`elementwise_loss` in xdiffusion_tpu/scheduler.py. For the DDPM and logSNR
schedules: the schedule and every derived table are built in float64 numpy
and stored as float32, exactly as the JAX package builds them. Per-timestep
lookups gather from the tables on the tables' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Dict, Tuple

import numpy as np
import torch

import torch.nn.functional as F

from xdiffusion_tpu_torch.utils import broadcast_from_left, extract, log1mexp


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


def cosine_logsnr_schedule(num_scales: int, logsnr_min: float, logsnr_max: float
                           ) -> np.ndarray:
    """-2 log tan(a t + b) on num_scales points of t in [0, 1]: logsnr_max at
    t = 0, logsnr_min at t = 1."""
    b = math.atan(math.exp(-0.5 * logsnr_max))
    a = math.atan(math.exp(-0.5 * logsnr_min)) - b
    t = np.linspace(0.0, 1.0, num_scales, dtype=np.float64)
    return -2.0 * np.log(np.tan(a * t + b))


def linear_logsnr_schedule(num_scales: int, logsnr_min: float, logsnr_max: float
                           ) -> np.ndarray:
    t = np.linspace(0.0, 1.0, num_scales, dtype=np.float64)
    return logsnr_max + (logsnr_min - logsnr_max) * t


def elementwise_loss(loss_type: str, pred: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    if loss_type == "l2":
        return (pred - target) ** 2
    if loss_type == "l1":
        return (pred - target).abs()
    if loss_type == "huber":  # smooth_l1 with beta=1
        d = (pred - target).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise NotImplementedError(f"Loss function {loss_type} not implemented.")


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
        return _tables_to(self, device)

    def steps(self) -> int:
        return self.num_timesteps

    def continuous(self) -> bool:
        return False

    def sample_random_times(self, batch_size: int, generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform integer timesteps (B,) on the tables' device, unit weights."""
        device = self.betas.device
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator,
                          device=device)
        return t, torch.ones((batch_size,), dtype=torch.float32, device=device)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return (extract(self.sqrt_alphas_cumprod, t, x_start.shape) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, x_start.shape) * noise)

    def predict_v_from_x_and_epsilon(self, x: torch.Tensor, epsilon: torch.Tensor,
                                     t: torch.Tensor) -> torch.Tensor:
        alpha_t = extract(self.sqrt_alphas_cumprod, t, x.shape)
        sigma_t = extract(self.sqrt_one_minus_alphas_cumprod, t, x.shape)
        return alpha_t * epsilon - sigma_t * x

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


def _tables_to(obj, device):
    """A copy of the frozen dataclass `obj` with every table on `device`."""
    return replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in fields(obj) if isinstance(getattr(obj, f.name), torch.Tensor)
    })


@dataclass(frozen=True, eq=False)
class ContinuousNoiseScheduler:
    """Continuous-time variance-preserving process over a logSNR table:
    gammas[i] = logSNR(i / num_timesteps) for i in 0 ... num_timesteps. A time
    t in [0, 1] reads entry int32(t * num_timesteps), the product taken in
    fp32 and truncated as the JAX package takes it (a float64 product would
    move a t next to a boundary onto the neighbouring entry). The posterior
    follows Progressive Distillation (2202.00512, Eq. 5) with expm1/log1mexp
    numerics."""

    gammas: torch.Tensor       # (num_timesteps + 1,)
    alphas: torch.Tensor       # sqrt(sigmoid(gamma))
    sigma2: torch.Tensor       # sigmoid(-gamma)
    sqrt_sigma2: torch.Tensor
    num_timesteps: int
    loss_type: str = "l2"

    @classmethod
    def create(cls, num_scales: int = 1000, logsnr_schedule: str = "cosine",
               loss_type: str = "l2", logsnr_min: float = -20.0, logsnr_max: float = 20.0,
               **_ignored) -> "ContinuousNoiseScheduler":
        if logsnr_schedule == "cosine":
            gammas = cosine_logsnr_schedule(num_scales + 1, logsnr_min, logsnr_max)
        elif logsnr_schedule == "linear":
            gammas = linear_logsnr_schedule(num_scales + 1, logsnr_min, logsnr_max)
        else:
            raise NotImplementedError(f"Noise schedule {logsnr_schedule} not implemented.")
        sigma2 = 1.0 / (1.0 + np.exp(gammas))

        def f32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32))

        return cls(gammas=f32(gammas), alphas=f32(np.sqrt(1.0 - sigma2)), sigma2=f32(sigma2),
                   sqrt_sigma2=f32(np.sqrt(sigma2)), num_timesteps=int(num_scales),
                   loss_type=loss_type)

    def to(self, device) -> "ContinuousNoiseScheduler":
        return _tables_to(self, device)

    def steps(self) -> int:
        return self.num_timesteps

    def continuous(self) -> bool:
        return True

    def sample_random_times(self, batch_size: int, generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform fp32 times (B,) in [0, 1) on the tables' device, unit weights."""
        t = torch.rand((batch_size,), generator=generator, device=self.gammas.device)
        return t, torch.ones_like(t)

    def index(self, t: torch.Tensor) -> torch.Tensor:
        """The table entry of each time: int32(fp32(t) * num_timesteps),
        clipped to [0, num_timesteps]."""
        idx = (t.float() * self.num_timesteps).to(torch.int32)
        return idx.clamp(0, self.num_timesteps).to(self.gammas.device).long()

    def logsnr(self, t: torch.Tensor) -> torch.Tensor:
        return self.gammas[self.index(t)]

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        idx = self.index(t)
        return (extract(self.alphas, idx, x_start.shape) * x_start
                + extract(self.sqrt_sigma2, idx, x_start.shape) * noise)

    def variance_fixed_large(self, context: Dict, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        logsnr_t = broadcast_from_left(context["logsnr_t"], shape)
        logsnr_s = broadcast_from_left(context["logsnr_s"], shape)
        one_minus_r = -torch.expm1(logsnr_t - logsnr_s)
        log_one_minus_r = log1mexp(logsnr_s - logsnr_t)
        var = one_minus_r * torch.sigmoid(-logsnr_t)
        logvar = log_one_minus_r + F.logsigmoid(-logsnr_t)
        return var, logvar

    def q_posterior(self, x_start, x_t, context: Dict) -> Tuple[torch.Tensor, ...]:
        """Mean, variance and log-variance of q(z_s | z_t, x); the variance
        floored at 1e-20, as the JAX package floors it."""
        logsnr_s = broadcast_from_left(context["logsnr_s"], x_t.shape)
        logsnr_t = broadcast_from_left(context["logsnr_t"], x_t.shape)
        alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
        # alpha_s / alpha_t, stable at t -> 1.
        alpha_st = torch.sqrt((1.0 + torch.exp(-logsnr_t)) / (1.0 + torch.exp(-logsnr_s)))
        r = torch.exp(logsnr_t - logsnr_s)
        one_minus_r = -torch.expm1(logsnr_t - logsnr_s)
        mean = r * alpha_st * x_t + one_minus_r * alpha_s * x_start
        log_one_minus_r = log1mexp(logsnr_s - logsnr_t)
        variance = one_minus_r * torch.sigmoid(-logsnr_s)
        log_variance = log_one_minus_r + F.logsigmoid(-logsnr_s)
        return mean, variance, log_variance.clamp(min=math.log(1e-20))

    def predict_x_from_epsilon(self, z, epsilon, context: Dict):
        logsnr_t = broadcast_from_left(context["logsnr_t"], z.shape)
        return torch.sqrt(1.0 + torch.exp(-logsnr_t)) * (
            z - epsilon * torch.rsqrt(1.0 + torch.exp(logsnr_t)))

    def predict_x_from_v(self, z, v, context: Dict):
        logsnr_t = broadcast_from_left(context["logsnr_t"], z.shape)
        alpha_t = torch.sqrt(torch.sigmoid(logsnr_t))
        sigma_t = torch.sqrt(torch.sigmoid(-logsnr_t))
        return alpha_t * z - sigma_t * v

    def predict_v_from_x_and_epsilon(self, x: torch.Tensor, epsilon: torch.Tensor,
                                     t: torch.Tensor) -> torch.Tensor:
        idx = self.index(t)
        return (extract(self.alphas, idx, x.shape) * epsilon
                - extract(self.sqrt_sigma2, idx, x.shape) * x)

    def predict_epsilon_from_x(self, z, x, context: Dict):
        logsnr_t = broadcast_from_left(context["logsnr_t"], z.shape)
        return torch.sqrt(1.0 + torch.exp(logsnr_t)) * (
            z - x * torch.rsqrt(1.0 + torch.exp(-logsnr_t)))


def continuous_noise_scheduler(**kwargs) -> ContinuousNoiseScheduler:
    """Config factory: the importance_sampler sub-block is for the process."""
    kwargs.pop("importance_sampler", None)
    return ContinuousNoiseScheduler.create(**kwargs)


@dataclass(frozen=True)
class DiscreteRectifiedFlowNoiseScheduler:
    """Rectified-flow interpolant x_t = t * x0 + (1 - t) * eps: t = 1 is data,
    t = 0 is noise. Times are drawn uniform, uniform-clipped (to
    [epsilon, max_time]) or logit-normal (sigmoid of a standard normal)."""

    num_steps: int
    max_time: float = 1.0
    epsilon: float = 1e-3
    distribution: str = "uniform-clipped"
    loss_type: str = "l2"

    @classmethod
    def create(cls, steps: int = 1000, max_time: float = 1.0,
               distribution: str = "uniform-clipped", loss_type: str = "l2",
               **_ignored) -> "DiscreteRectifiedFlowNoiseScheduler":
        if distribution not in ("uniform", "uniform-clipped", "logit-normal"):
            raise ValueError(f"unknown time distribution {distribution!r}")
        eps = 1e-3 if distribution == "uniform-clipped" else 0.0
        return cls(num_steps=int(steps), max_time=float(max_time), epsilon=eps,
                   distribution=distribution, loss_type=loss_type)

    def to(self, device) -> "DiscreteRectifiedFlowNoiseScheduler":
        return self  # holds no tensors

    def steps(self) -> int:
        return self.num_steps

    def continuous(self) -> bool:
        return False

    def sample_random_times(self, batch_size: int, generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) fp32 times on the generator's device, unit weights."""
        device = generator.device
        if self.distribution == "logit-normal":
            u = torch.randn((batch_size,), generator=generator, device=device)
            base = torch.sigmoid(u)
        else:
            base = torch.rand((batch_size,), generator=generator, device=device)
        t = base * (self.max_time - self.epsilon) + self.epsilon
        return t, torch.ones_like(t)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        t_expanded = broadcast_from_left(t, x_start.shape)
        return t_expanded * x_start + (1.0 - t_expanded) * noise


def rectified_flow_noise_scheduler(**kwargs) -> DiscreteRectifiedFlowNoiseScheduler:
    """Config factory: the importance_sampler sub-block is for the process."""
    kwargs.pop("importance_sampler", None)
    return DiscreteRectifiedFlowNoiseScheduler.create(**kwargs)
