"""Rectified-flow Euler sampler.

Counterpart of `AncestralSampler` in xdiffusion_tpu/samplers/
rectified_flow.py: time runs forward from noise (t = 0) to data (t = 1);
each step maps the descending step index onto t in [eps, T - eps] and takes
x += v_theta * dt. The JAX sampler writes the general Euler-Maruyama step;
the rectified-flow SDE's sigma_t is 0, so its correction and noise terms
vanish and only the ODE step is computed here.

The reference quirk is kept: the index flip, the time mapping and dt all use
the SDE's N, not the number of steps asked for, so fewer steps integrate
only the last num_steps / N of the ODE.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from xdiffusion_tpu_torch.samplers.base import ReverseProcessSampler, predict_guided


class AncestralSampler(ReverseProcessSampler):
    """Euler solver on the learned velocity field."""

    def __init__(self, **kwargs):
        pass

    def step_context(self, process, num_steps: int) -> Dict[str, torch.Tensor]:
        sde = process.sde()
        eps = 1e-3
        idx = np.arange(num_steps - 1, -1, -1, dtype=np.int32)
        fwd = sde.N - (idx + 1)
        num_t = fwd.astype(np.float32) / sde.N * (sde.T - eps) + eps
        return {
            "timestep_idx": torch.from_numpy(idx),
            "timestep": torch.from_numpy(num_t),
            "is_last": torch.from_numpy(idx == 0),
            "dt": torch.full((num_steps,), 1.0 / sde.N, dtype=torch.float32),
        }

    def p_sample(self, x, context, unconditional_context, process, generator,
                 classifier_free_guidance=None) -> torch.Tensor:
        # Velocity prediction; guidance mixes velocities like epsilons.
        pred = predict_guided(process, x, context, unconditional_context,
                              classifier_free_guidance)
        return x + pred * context["dt"]
