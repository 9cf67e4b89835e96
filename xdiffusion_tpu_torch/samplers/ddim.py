"""Deterministic DDIM sampler.

Counterpart of xdiffusion_tpu/samplers/ddim.py: z_s = alpha_s * x_hat +
sigma_s * eps_hat from the per-step logSNR pair: a continuous schedule's at
times i / T, or, on a discrete schedule, the alpha_bar table respaced onto
num_steps points.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xdiffusion_tpu_torch.diffusion import PredictionType
from xdiffusion_tpu_torch.samplers.base import (
    ReverseProcessSampler,
    continuous_step_context,
    predict_x_hat,
)
from xdiffusion_tpu_torch.utils import broadcast_from_left


class DDIMSampler(ReverseProcessSampler):
    def __init__(self, **kwargs):
        pass

    def step_context(self, process, num_steps: int) -> Dict[str, torch.Tensor]:
        sched = process.noise_scheduler()
        if sched.continuous():
            return continuous_step_context(process, num_steps)
        idx = np.arange(num_steps - 1, -1, -1, dtype=np.int32)
        # Scan entry i sits at native index round(i * (S - 1) / (T - 1)).
        spaced = np.round(np.linspace(0, sched.steps() - 1, num_steps)).astype(np.int64)
        t_native = torch.from_numpy(spaced[idx])
        s_native = torch.from_numpy(np.concatenate([[0], spaced[:-1]])[idx])
        dev = sched.alphas_cumprod.device
        return {
            "timestep_idx": torch.from_numpy(idx),
            "is_last": torch.from_numpy(idx == 0),
            "timestep": t_native,
            "logsnr_t": sched.logsnr_from_index(t_native.to(dev)),
            "logsnr_s": sched.logsnr_from_index(s_native.to(dev)),
        }

    def p_sample(self, x, context, unconditional_context, process, generator,
                 classifier_free_guidance=None) -> torch.Tensor:
        x_hat, _, _, pred = predict_x_hat(process, x, context, unconditional_context,
                                          classifier_free_guidance, clip_denoised=True)
        if context["is_last"]:
            return x_hat
        sched = process.noise_scheduler()
        if process.prediction_type() == PredictionType.EPSILON:
            pred_epsilon = pred
        else:
            # V: epsilon comes from the unclipped x_hat.
            x_hat_raw = sched.predict_x_from_v(z=x, v=pred, context=context)
            pred_epsilon = sched.predict_epsilon_from_x(z=x, x=x_hat_raw, context=context)
        logsnr_s = broadcast_from_left(context["logsnr_s"], x.shape)
        alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
        stdv_s = torch.sqrt(torch.sigmoid(-logsnr_s))
        return alpha_s * x_hat + stdv_s * pred_epsilon
