"""Rectified-flow "SDE" shell.

Counterpart of `RectifiedFlow` in xdiffusion_tpu/sde/rectified_flow.py: a
probability-flow ODE (sigma_t = 0, unit noise scale) on t in [0, T],
discretized into N steps. The rectified-flow sampler reads only N and T;
the rest of the JAX `SDE` protocol (drift, marginals, sigma_t) comes with
the first score-SDE process that needs it.
"""

from __future__ import annotations


class RectifiedFlow:
    def __init__(self, N: int = 1000, T: float = 1.0, **kwargs):
        self.N = int(N)  # discretization steps
        self.T = float(T)
