"""Training-time timestep samplers.

Counterpart of `UniformSampler` in xdiffusion_tpu/importance_sampling.py.
"""

from __future__ import annotations

import numpy as np


class UniformSampler:
    """Uniform timesteps with unit weights."""

    def __init__(self, num_timesteps: int):
        self._num_timesteps = int(num_timesteps)

    def weights(self) -> np.ndarray:
        return np.ones([self._num_timesteps])
