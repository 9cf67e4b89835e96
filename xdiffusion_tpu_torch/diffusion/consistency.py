"""Consistency models: the training and distillation losses, the target and
EMA networks, sampling.

Counterpart of xdiffusion_tpu/diffusion/consistency.py ("Consistency
Models", arXiv:2303.01469). The JAX package keeps one params dict
{"score", "target", "ema"?} of EDMPrecond trees; here the process holds
three `nn.Module`s: the online `score` network (the only one trained), the
`target` network the loss evaluates the next boundary with, and the
optional sampling `ema`. `update_auxiliary_params` moves both toward the
updated score network after each optimizer step. The (EMA rate, N scales)
schedule is host-side (layers/ema.py); N enters the loss as an integer.

Randomness: each loss draws the boundary indices, then the noise, from an
explicit generator, or takes them injected (`indices=`, `noise=`); JAX
draws both inside the loss from one key. Every network runs without
dropout in the losses, as the JAX losses call `net.apply` without
`deterministic=False`.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config
from xdiffusion_tpu_torch.layers.ema import create_ema_and_scales_fn
from xdiffusion_tpu_torch.train_step import update_ema
from xdiffusion_tpu_torch.utils import (
    broadcast_from_left,
    mean_flat,
    normalize_to_neg_one_to_one,
    resolve_device,
    unnormalize_to_zero_to_one,
)


def get_weightings(weight_schedule: str, snrs: torch.Tensor, sigma_data: float):
    if weight_schedule == "snr":
        return snrs
    if weight_schedule == "snr+1":
        return snrs + 1.0
    if weight_schedule == "karras":
        return snrs + 1.0 / sigma_data ** 2
    if weight_schedule == "truncated-snr":
        return torch.clamp(snrs, min=1.0)
    if weight_schedule == "uniform":
        return torch.ones_like(snrs)
    raise NotImplementedError(weight_schedule)


def _karras_boundaries(indices: torch.Tensor, num_scales, sigma_min: float, sigma_max: float,
                       rho: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma(t_i) and sigma(t_{i+1}) of the rho-spaced boundaries for fp32
    indices; num_scales an integer (tensor), in fp32 as the JAX package
    computes them."""
    inv_rho_max = sigma_max ** (1.0 / rho)
    inv_rho_min = sigma_min ** (1.0 / rho)
    n = torch.as_tensor(num_scales, device=indices.device)
    denom = torch.clamp(n - 1, min=1).to(torch.float32)
    t = (inv_rho_max + indices / denom * (inv_rho_min - inv_rho_max)) ** rho
    t2 = (inv_rho_max + (indices + 1) / denom * (inv_rho_min - inv_rho_max)) ** rho
    return t, t2


class _ConsistencyLossBase:
    def __init__(self, sigma_data: float = 0.5, rho: float = 7.0, loss_norm: str = "l2",
                 weight_schedule: str = "uniform", **_):
        self.sigma_data = float(sigma_data)
        self.rho = float(rho)
        self.loss_norm = loss_norm
        self.weight_schedule = weight_schedule

    def _norm(self, distiller, target, weights):
        if self.loss_norm == "l1":
            return mean_flat(torch.abs(distiller - target)) * weights
        if self.loss_norm in ("l2", "lpips", "l2-32"):
            # lpips needs pretrained VGG features; it degrades to l2, as in
            # the JAX package.
            return mean_flat((distiller - target) ** 2) * weights
        raise ValueError(f"Unknown loss norm {self.loss_norm}")

    def _draws(self, net, x_start, num_scales, indices, noise, generator):
        """The boundaries t, t2 and the noise: indices uniform in [0, max(N -
        1, 1)) and then unit noise from `generator`, unless injected."""
        def need_generator():
            if generator is None:
                raise ValueError("consistency loss: pass a generator for its random draws")
            return generator

        b = x_start.shape[0]
        if indices is None:
            indices = torch.randint(0, max(int(num_scales) - 1, 1), (b,),
                                    generator=need_generator(), device=x_start.device)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=need_generator(),
                                device=x_start.device)
        indices = torch.as_tensor(indices, device=x_start.device).to(torch.float32)
        t, t2 = _karras_boundaries(indices, num_scales, net.sigma_min, net.sigma_max, self.rho)
        return t, t2, torch.as_tensor(noise, dtype=x_start.dtype, device=x_start.device)

    def _target(self, target_net, x_t2, t2, labels):
        with torch.no_grad():
            return target_net(x_t2, t2, class_labels=labels)


class ConsistencyTrainingLoss(_ConsistencyLossBase):
    """Eq. 10 of arXiv:2303.01469: f(x_{t_{i+1}}) against the target
    network's f at the Euler step toward x0."""

    def __call__(self, net, target_net, images: torch.Tensor, num_scales, labels=None,
                 indices=None, noise=None, generator=None) -> torch.Tensor:
        x_start = images
        t, t2, noise = self._draws(net, x_start, num_scales, indices, noise, generator)
        x_t = x_start + noise * broadcast_from_left(t, x_start.shape)
        distiller = net(x_t, t, class_labels=labels)

        # Euler solver from the ground-truth x0 (training mode).
        d = (x_t - x_start) / broadcast_from_left(t, x_t.shape)
        x_t2 = (x_t + d * broadcast_from_left(t2 - t, x_t.shape)).detach()
        distiller_target = self._target(target_net, x_t2, t2, labels)
        weights = get_weightings(self.weight_schedule, t ** -2, self.sigma_data)
        return self._norm(distiller, distiller_target, weights)


class ConsistencyDistillationLoss(_ConsistencyLossBase):
    """Eq. 7 of arXiv:2303.01469: a Heun step through a frozen teacher."""

    def __call__(self, net, target_net, images: torch.Tensor, num_scales,
                 teacher_denoise_fn: Callable = None, labels=None, indices=None, noise=None,
                 generator=None) -> torch.Tensor:
        assert teacher_denoise_fn is not None
        x_start = images
        t, t2, noise = self._draws(net, x_start, num_scales, indices, noise, generator)
        x_t = x_start + noise * broadcast_from_left(t, x_start.shape)
        distiller = net(x_t, t, class_labels=labels)

        # Heun solver through the teacher.
        with torch.no_grad():
            denoiser = teacher_denoise_fn(x_t, t)
            d = (x_t - denoiser) / broadcast_from_left(t, x_t.shape)
            samples = x_t + d * broadcast_from_left(t2 - t, x_t.shape)
            denoiser2 = teacher_denoise_fn(samples, t2)
            next_d = (samples - denoiser2) / broadcast_from_left(t2, x_t.shape)
            x_t2 = x_t + (d + next_d) * broadcast_from_left((t2 - t) / 2.0, x_t.shape)
        distiller_target = self._target(target_net, x_t2, t2, labels)
        weights = get_weightings(self.weight_schedule, t ** -2, self.sigma_data)
        return self._norm(distiller, distiller_target, weights)


class GaussianDiffusion_ConsistencyModel:
    """The consistency process over an EDM-preconditioned network, on
    `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, config: DotConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        diff = config.diffusion
        self._net = instantiate_from_config(diff.score_network.to_dict())
        self._net.to(self.device).eval()
        self._target = copy.deepcopy(self._net).requires_grad_(False)
        self._ema = (copy.deepcopy(self._net).requires_grad_(False)
                     if "exponential_moving_average" in diff else None)
        self._loss = instantiate_from_config(diff.loss.to_dict())
        self._sampler = instantiate_from_config(diff.sampling.to_dict())
        cm = diff.consistency_model
        self._rho = float(cm.get("rho", 7.0))
        self._target_ema_cfg = cm.target_ema.to_dict()

    # -- protocol ------------------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def score_network(self) -> torch.nn.Module:
        """The online network, the only one trained."""
        return self._net

    def networks(self) -> Dict[str, torch.nn.Module]:
        """{"score", "target"[, "ema"]}: the JAX package's params keys."""
        nets = {"score": self._net, "target": self._target}
        if self._ema is not None:
            nets["ema"] = self._ema
        return nets

    def sampling_network(self) -> torch.nn.Module:
        """The network `sample` runs: the EMA network where there is one."""
        return self._ema if self._ema is not None else self._net

    def scale_fn(self, total_steps: int) -> Callable[[int], Tuple[float, int]]:
        """The host-side (target EMA rate, N scales) schedule of a run."""
        return create_ema_and_scales_fn(total_steps=total_steps, **self._target_ema_cfg)

    # -- training ------------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      teacher_denoise_fn: Optional[Callable] = None,
                      indices: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss on a (B, H, W, C) batch in [0, 1]; context carries
        "num_scales" (the schedule's N) and optionally "classes". A
        distillation loss takes `teacher_denoise_fn(x, sigma)`. `generator`
        draws the indices, then the noise, unless `indices` (integers in
        [0, max(N - 1, 1))) and `noise` (unit normal) are given."""
        if "num_scales" not in context:
            raise ValueError(
                "consistency loss_on_batch: context['num_scales'] is missing; consistency "
                "models train through `python -m xdiffusion_tpu_torch.distill_consistency`, "
                "which runs the N-scales schedule")
        x = normalize_to_neg_one_to_one(images)
        num_scales = context["num_scales"]
        kwargs = {}
        if isinstance(self._loss, ConsistencyDistillationLoss):
            kwargs["teacher_denoise_fn"] = teacher_denoise_fn
        losses = self._loss(self._net, self._target, x, num_scales,
                            labels=context.get("classes"), indices=indices, noise=noise,
                            generator=generator, **kwargs)
        loss = losses.mean()
        return loss, {"loss": loss, "mse_loss": loss, "vb_loss": torch.zeros_like(loss),
                      "timesteps": torch.as_tensor(num_scales),
                      "loss_per_example": losses.detach()}

    @torch.no_grad()
    def update_auxiliary_params(self, target_ema: float, ema_rate: Optional[float]) -> None:
        """Moves the target network toward the (updated) score network by the
        schedule's rate, taken in fp32 as the JAX step's traced scalar, and
        the sampling EMA by `ema_rate`: t * r + s * (1 - r)."""
        update_ema(self._target, self._net, float(np.float32(target_ema)))
        if self._ema is not None and ema_rate is not None:
            update_ema(self._ema, self._net, ema_rate)

    # -- sampling ------------------------------------------------------------

    def sampling_shape(self, num_samples: int) -> Tuple[int, ...]:
        sampling = self._config.diffusion.sampling
        s = sampling.output_spatial_size
        spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        return (num_samples, spatial[0], spatial[1], sampling.output_channels)

    @torch.inference_mode()
    def sample(self, num_samples: int = 16, context: Optional[Dict] = None,
               classifier_free_guidance: Optional[float] = None,
               num_sampling_steps: Optional[int] = None, sampler=None,
               initial_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(num_samples, H, W, C) samples in [0, 1] from the EMA network (else
        the score network) by the config's consistency sampler (or
        `sampler`). Guidance, the step count and the context's classes are
        taken and ignored, as in the JAX package; `context["sampling_noise"]`
        ((draws, *shape)) replaces the per-step draws, `initial_noise` the
        latents, which `generator` draws otherwise."""
        context = dict(context or {})
        shape = self.sampling_shape(num_samples)
        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if initial_noise is not None:
            latents = torch.as_tensor(initial_noise, dtype=torch.float32, device=device)
        else:
            latents = torch.randn(shape, generator=generator, device=device)
        injected = context.get("sampling_noise")
        if injected is not None:
            injected = torch.as_tensor(injected, dtype=torch.float32, device=device)
        net = self.sampling_network()
        net.eval()

        def draw(i):
            if injected is not None:
                return injected[i]
            return torch.randn(shape, generator=generator, device=device)

        x = (sampler or self._sampler).run(net, lambda x, sigma: net(x, sigma), latents, draw)
        return unnormalize_to_zero_to_one(x)
