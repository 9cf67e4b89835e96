"""Ancestral (DDPM) sampler.

Counterpart of xdiffusion_tpu/samplers/ancestral.py: the posterior mean of
the clipped x0 prediction plus fixed-large noise, and the clean prediction
at the last step. A discrete schedule is walked at native timesteps T-1 ...
0 of the T steps asked for; a continuous one at times i / T with the logSNR
pair of each step.

Reconstruction guidance ("Video Diffusion Models" Eq. 7, for extending a
video): with `reconstruction_guidance` and conditioning frames
context["x_a"] (B, Fa, H, W, C, model space), the first
`num_frame_overlap` (k) frames of z are replaced by the last k of x_a noised
to the step's time, and the prediction of the remaining frames is pulled
towards agreement with x_a: x_hat_b - (omega / 2) alpha_t grad_z
||x_a[-k:] - x_hat_a(z)||^2, while the first k frames of x_hat are x_a's.
The gradient runs the score network's backward inside the sampling loop,
with autograd enabled for that step alone. The JAX package draws the noise
of x_a from fold_in(step key, 11); here it is drawn from the sampling
generator, or taken from context["reconstruction_noise"].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xdiffusion_tpu_torch.utils import broadcast_from_left
from xdiffusion_tpu_torch.samplers.base import (
    ReverseProcessSampler,
    continuous_step_context,
    predict_x_hat,
)


class AncestralSampler(ReverseProcessSampler):
    def __init__(self, reconstruction_guidance: bool = False, omega: float = 2.0,
                 num_frame_overlap: int = 4, **kwargs):
        self.reconstruction_guidance = bool(reconstruction_guidance)
        self._omega = float(omega)
        self._num_frame_overlap = int(num_frame_overlap)

    def needs_autograd(self, context) -> bool:
        """Whether sampling with `context` differentiates the network."""
        return self.reconstruction_guidance and context is not None and "x_a" in context

    def step_context(self, process, num_steps: int) -> Dict[str, torch.Tensor]:
        if process.noise_scheduler().continuous():
            return continuous_step_context(process, num_steps)
        idx = np.arange(num_steps - 1, -1, -1, dtype=np.int32)
        return {
            "timestep_idx": torch.from_numpy(idx),
            "is_last": torch.from_numpy(idx == 0),
            "timestep": torch.from_numpy(idx.astype(np.int64)),
        }

    def p_sample(self, x, context, unconditional_context, process, generator,
                 classifier_free_guidance=None) -> torch.Tensor:
        if self.needs_autograd(context):
            x_hat, log_variance = self._guided_x_hat(
                x, context, unconditional_context, process, generator,
                classifier_free_guidance)
        else:
            x_hat, _, log_variance, _ = predict_x_hat(
                process, x, context, unconditional_context, classifier_free_guidance,
                clip_denoised=True)
        if context["is_last"]:
            return x_hat
        mean, _, _ = process.noise_scheduler().q_posterior(x_start=x_hat, x_t=x,
                                                           context=context)
        noise = context.get("sampling_noise")
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        return mean + torch.exp(0.5 * log_variance) * noise.to(x.dtype)

    def _guided_x_hat(self, x, context, unconditional_context, process, generator,
                      classifier_free_guidance):
        """(x_hat, log_variance) of reconstruction guidance (module docstring)."""
        sched = process.noise_scheduler()
        if not sched.continuous():
            raise ValueError("reconstruction guidance needs a continuous (logSNR) schedule")
        k = self._num_frame_overlap
        x_a = context["x_a"].to(x.dtype)
        noise = context.get("reconstruction_noise")
        if noise is None:
            noise = torch.randn(x_a.shape, generator=generator, device=x_a.device,
                                dtype=x_a.dtype)
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            z_a = sched.q_sample(x_start=x_a, t=context["timestep"], noise=noise.to(x.dtype))
            z_t = torch.cat([z_a[:, -k:], z[:, k:]], dim=1)
            x_hat_ab, _, log_variance, _ = predict_x_hat(
                process, z_t, context, unconditional_context, classifier_free_guidance,
                clip_denoised=True)
            loss = ((x_a[:, -k:] - x_hat_ab[:, :k]) ** 2).mean()
            (grad,) = torch.autograd.grad(loss, z)
        alpha_t = torch.sqrt(torch.sigmoid(broadcast_from_left(context["logsnr_t"], x.shape)))
        x_tilde_b = (x_hat_ab - self._omega * alpha_t * 0.5 * grad)[:, k:]
        x_hat = torch.cat([x_a[:, -k:], x_tilde_b.detach()], dim=1)
        return x_hat, log_variance.detach()
