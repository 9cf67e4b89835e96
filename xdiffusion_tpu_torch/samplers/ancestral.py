"""Ancestral (DDPM) sampler.

Counterpart of xdiffusion_tpu/samplers/ancestral.py without reconstruction
guidance (the video extension's, which waits for the video UNets): the
posterior mean of the clipped x0 prediction plus fixed-large noise, and the
clean prediction at the last step. A discrete schedule is walked at native
timesteps T-1 ... 0 of the T steps asked for; a continuous one at times
i / T with the logSNR pair of each step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xdiffusion_tpu_torch.samplers.base import (
    ReverseProcessSampler,
    continuous_step_context,
    predict_x_hat,
)


class AncestralSampler(ReverseProcessSampler):
    def __init__(self, reconstruction_guidance: bool = False, **kwargs):
        if reconstruction_guidance:
            raise NotImplementedError("reconstruction guidance is not ported yet")

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
