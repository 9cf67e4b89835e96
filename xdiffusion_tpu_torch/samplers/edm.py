"""The EDM samplers (Karras et al., Algorithm 2 and its design space).

Counterpart of xdiffusion_tpu/samplers/edm.py. The step tables (sigma
discretisation, schedule, scaling, churn) are computed on the host in the
JAX package's numpy dtypes and kept in fp32, as it keeps them; each step is
one Euler or two Heun network evaluations. The JAX scan evaluates the Heun
correction on the last step too and discards it (t_next = 0); the port
skips that evaluation, so an n-step Heun run makes 2n - 1 evaluations with
the same result. Each step takes one standard-normal draw, `draw(i)`, even
where its noise coefficient is 0, as the JAX loop draws one every step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _tables(values: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in values.items()}


class StochasticSampler:
    """EDM Algorithm 2: rho-spaced sigmas, optional churn, Heun correction."""

    def __init__(self, num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, S_churn: float = 0.0, S_min: float = 0.0,
                 S_max: float = float("inf"), S_noise: float = 1.0, **kwargs):
        self.num_steps = int(num_steps)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.S_churn = float(S_churn)
        self.S_min = float(S_min)
        self.S_max = float(S_max)
        self.S_noise = float(S_noise)

    def t_steps(self, net) -> np.ndarray:
        sigma_min = max(self.sigma_min, net.sigma_min)
        sigma_max = min(self.sigma_max, net.sigma_max)
        i = np.arange(self.num_steps, dtype=np.float64)
        t = (sigma_max ** (1 / self.rho) + i / (self.num_steps - 1)
             * (sigma_min ** (1 / self.rho) - sigma_max ** (1 / self.rho))) ** self.rho
        return np.concatenate([t, [0.0]])

    def run(self, net_module, net: Callable, latents: torch.Tensor,
            draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
        """x0 from `latents` (unit normal): net(x, sigma) is the denoiser,
        net_module the preconditioner (its sigma range)."""
        t_steps = self.t_steps(net_module)
        n = self.num_steps
        t_cur, t_next = t_steps[:-1], t_steps[1:]
        gamma = np.where((self.S_min <= t_cur) & (t_cur <= self.S_max),
                         min(self.S_churn / n, math.sqrt(2.0) - 1.0), 0.0)
        t_hat = t_cur + gamma * t_cur
        noise_coef = np.sqrt(np.maximum(t_hat ** 2 - t_cur ** 2, 0.0)) * self.S_noise
        second_order = np.arange(n) < n - 1
        per = _tables({"t_hat": t_hat, "t_next": t_next, "noise_coef": noise_coef},
                      latents.device)
        x = latents * float(t_steps[0])
        for i in range(n):
            t_h, t_n = per["t_hat"][i], per["t_next"][i]
            x_hat = x + per["noise_coef"][i] * draw(i)
            d_cur = (x_hat - net(x_hat, t_h)) / t_h
            x = x_hat + (t_n - t_h) * d_cur
            if second_order[i]:  # Heun's correction; t_next > 0 here
                d_prime = (x - net(x, t_n)) / t_n
                x = x_hat + (t_n - t_h) * 0.5 * (d_cur + d_prime)
        return x


class GeneralizedStochasticSampler:
    """Every design point of the EDM paper: discretisation in {vp, ve, iddpm,
    edm}, schedule {vp, ve, linear}, scaling {vp, none}, solver {euler,
    heun}, with churn."""

    def __init__(self, num_steps: int = 18, sigma_min: Optional[float] = None,
                 sigma_max: Optional[float] = None, rho: float = 7.0, S_churn: float = 0.0,
                 S_min: float = 0.0, S_max: float = float("inf"), S_noise: float = 1.0,
                 solver: str = "euler", discretization: str = "vp", schedule: str = "vp",
                 scaling: str = "vp", epsilon_s: float = 1e-3, C_1: float = 0.001,
                 C_2: float = 0.008, M: int = 1000, alpha: float = 1.0, **kwargs):
        assert solver in ("euler", "heun")
        assert discretization in ("vp", "ve", "iddpm", "edm")
        assert schedule in ("vp", "ve", "linear")
        assert scaling in ("vp", "none")
        self.num_steps = int(num_steps)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.rho = float(rho)
        self.S_churn = float(S_churn)
        self.S_min = float(S_min)
        self.S_max = float(S_max)
        self.S_noise = float(S_noise)
        self.solver = solver
        self.discretization = discretization
        self.schedule = schedule
        self.scaling = scaling
        self.epsilon_s = float(epsilon_s)
        self.C_1 = float(C_1)
        self.C_2 = float(C_2)
        self.M = int(M)
        self.alpha = float(alpha)

    def tables(self, net) -> Dict[str, np.ndarray]:
        """The per-step tables (float64, from the JAX package's numpy
        expressions) and x0's scale; `net.round_sigma` rounds in fp32."""
        n = self.num_steps

        def vp_sigma(bd, bm):
            return lambda t: np.sqrt(np.exp(0.5 * bd * t ** 2 + bm * t) - 1.0)

        def vp_sigma_deriv(bd, bm, sig):
            return lambda t: 0.5 * (bm + bd * t) * (sig(t) + 1.0 / sig(t))

        def vp_sigma_inv(bd, bm):
            return lambda s: (np.sqrt(bm ** 2 + 2 * bd * np.log(s ** 2 + 1.0)) - bm) / bd

        def round_sigma(s):
            return net.round_sigma(torch.as_tensor(s)).detach().cpu().numpy()

        sigma_min, sigma_max = self.sigma_min, self.sigma_max
        if sigma_min is None:
            sigma_min = {"vp": vp_sigma(19.9, 0.1)(self.epsilon_s), "ve": 0.02, "iddpm": 0.002,
                         "edm": 0.002}[self.discretization]
        if sigma_max is None:
            sigma_max = {"vp": vp_sigma(19.9, 0.1)(1.0), "ve": 100.0, "iddpm": 81.0,
                         "edm": 80.0}[self.discretization]
        sigma_min = max(sigma_min, net.sigma_min)
        sigma_max = min(sigma_max, net.sigma_max)
        vp_beta_d = (2 * (np.log(sigma_min ** 2 + 1.0) / self.epsilon_s
                          - np.log(sigma_max ** 2 + 1.0)) / (self.epsilon_s - 1.0))
        vp_beta_min = np.log(sigma_max ** 2 + 1.0) - 0.5 * vp_beta_d

        idx = np.arange(n, dtype=np.float64)
        if self.discretization == "vp":
            orig_t = 1.0 + idx / (n - 1) * (self.epsilon_s - 1.0)
            sigma_steps = vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
        elif self.discretization == "ve":
            orig_t = (sigma_max ** 2) * ((sigma_min ** 2 / sigma_max ** 2) ** (idx / (n - 1)))
            sigma_steps = np.sqrt(orig_t)
        elif self.discretization == "iddpm":
            u = np.zeros(self.M + 1, dtype=np.float64)

            def alpha_bar(j):
                return np.sin(0.5 * np.pi * j / (self.M * (self.C_2 + 1))) ** 2

            for j in range(self.M, 0, -1):
                u[j - 1] = np.sqrt((u[j] ** 2 + 1.0)
                                   / max(alpha_bar(j - 1) / alpha_bar(j), self.C_1) - 1.0)
            u_filtered = u[(u >= sigma_min) & (u <= sigma_max)]
            sel = np.round((len(u_filtered) - 1) / (n - 1) * idx).astype(np.int64)
            sigma_steps = u_filtered[sel]
        else:  # edm
            lo, hi = sigma_min ** (1 / self.rho), sigma_max ** (1 / self.rho)
            sigma_steps = (hi + idx / (n - 1) * (lo - hi)) ** self.rho

        if self.schedule == "vp":
            sigma = vp_sigma(vp_beta_d, vp_beta_min)
            sigma_deriv = vp_sigma_deriv(vp_beta_d, vp_beta_min, sigma)
            sigma_inv = vp_sigma_inv(vp_beta_d, vp_beta_min)
        elif self.schedule == "ve":
            sigma = np.sqrt

            def sigma_deriv(t):
                return 0.5 / np.sqrt(t)

            def sigma_inv(s):
                return s ** 2
        else:
            def sigma(t):
                return t

            def sigma_deriv(t):
                return np.ones_like(np.asarray(t, dtype=np.float64))

            def sigma_inv(s):
                return s

        if self.scaling == "vp":
            def s_fn(t):
                return 1.0 / np.sqrt(1.0 + sigma(t) ** 2)

            def s_deriv(t):
                return -sigma(t) * sigma_deriv(t) * (s_fn(t) ** 3)
        else:
            def s_fn(t):
                return np.ones_like(np.asarray(t, dtype=np.float64))

            def s_deriv(t):
                return np.zeros_like(np.asarray(t, dtype=np.float64))

        t_steps = sigma_inv(round_sigma(sigma_steps))
        t_steps = np.concatenate([t_steps, [0.0]])
        t_cur, t_next = t_steps[:-1], t_steps[1:]
        gamma = np.where((self.S_min <= sigma(t_cur)) & (sigma(t_cur) <= self.S_max),
                         min(self.S_churn / n, math.sqrt(2.0) - 1.0), 0.0)
        t_hat = sigma_inv(round_sigma(sigma(t_cur) + gamma * sigma(t_cur)))

        def safe(v):
            return np.where(np.abs(v) < 1e-20, 1e-20, v)

        t_prime = t_hat + self.alpha * (t_next - t_hat)
        tables = {
            "ratio": s_fn(t_hat) / s_fn(t_cur),
            "noise_coef": np.sqrt(np.clip(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, 0.0, None))
            * s_fn(t_hat) * self.S_noise,
            "h": t_next - t_hat,
            "sigma_hat": sigma(t_hat),
            "s_hat": s_fn(t_hat),
            "A_hat": sigma_deriv(t_hat) / safe(sigma(t_hat)) + s_deriv(t_hat) / safe(s_fn(t_hat)),
            "B_hat": sigma_deriv(t_hat) * s_fn(t_hat) / safe(sigma(t_hat)),
            "sigma_prime": safe(sigma(t_prime)),
            "s_prime": safe(s_fn(t_prime)),
            "A_prime": sigma_deriv(t_prime) / safe(sigma(t_prime))
            + s_deriv(t_prime) / safe(s_fn(t_prime)),
            "B_prime": sigma_deriv(t_prime) * s_fn(t_prime) / safe(sigma(t_prime)),
            "second_order": ((np.arange(n) < n - 1) & (self.solver == "heun")).astype(np.float64),
        }
        return tables, float(sigma(t_steps[0]) * s_fn(t_steps[0]))

    def run(self, net_module, net: Callable, latents: torch.Tensor,
            draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
        tables, x0_scale = self.tables(net_module)
        per = _tables(tables, latents.device)
        second_order = tables["second_order"] > 0
        alpha = self.alpha
        x = latents * x0_scale
        for i in range(self.num_steps):
            p = {k: v[i] for k, v in per.items()}
            x_hat = p["ratio"] * x + p["noise_coef"] * draw(i)
            den = net(x_hat / p["s_hat"], p["sigma_hat"])
            d_cur = p["A_hat"] * x_hat - p["B_hat"] * den
            x = x_hat + p["h"] * d_cur
            if second_order[i]:
                x_prime = x_hat + alpha * p["h"] * d_cur
                den2 = net(x_prime / p["s_prime"], p["sigma_prime"])
                d_prime = p["A_prime"] * x_prime - p["B_prime"] * den2
                x = x_hat + p["h"] * ((1.0 - 1.0 / (2.0 * alpha)) * d_cur
                                      + (1.0 / (2.0 * alpha)) * d_prime)
        return x
