"""Consistency-model samplers: one-step, multistep and the Karras family,
and the Karras sigma ladder.

Counterpart of xdiffusion_tpu/samplers/consistency.py. Each sampler's
`run(net_module, net, latents, draw)` takes the preconditioned network
(its sigma range), the denoiser net(x, sigma) and unit-normal latents, and
returns x0 in [-1, 1]. The step tables (sigma ladders, churn, ancestral
step sizes, DPM midpoints) are computed in fp64 numpy on the host and kept
in fp32, as the JAX package keeps them for its scan. Per-step noise is
`draw(i)`, one unit-normal draw for each scan step where JAX draws one:
`ancestral`, `heun` (one more after its scan), `dpm` and `multistep`
(len(multistep) - 1 draws).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    """rho-spaced noise ladder, descending, with a trailing 0."""
    ramp = np.linspace(0, 1, n)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, [0.0]])


def _tables(values: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
            for k, v in values.items()}


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


class OneStepConsistencySampler:
    """x0 = f(x_T * sigma_max, sigma_max)."""

    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0, rho: float = 7.0,
                 clip_denoised: bool = True, **kwargs):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.clip_denoised = bool(clip_denoised)

    def run(self, net_module, net: Callable, latents: torch.Tensor,
            draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
        sigma_max = min(self.sigma_max, net_module.sigma_max)
        x0 = net(latents * sigma_max, _f32(sigma_max, latents.device))
        return torch.clamp(x0, -1.0, 1.0) if self.clip_denoised else x0


class GeneralizedConsistencySampler:
    """The consistency sampler family: `sampler` is one of heun, dpm,
    ancestral, euler, progdist, onestep and multistep; any other name
    raises when sampling starts, as the JAX package's build does."""

    def __init__(self, steps: int = 40, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, clip_denoised: bool = True, sampler: str = "multistep",
                 s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = float("inf"),
                 s_noise: float = 1.0, multistep: Optional[Sequence[int]] = None, **kwargs):
        self.steps = int(steps)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.rho = float(rho)
        self.clip_denoised = bool(clip_denoised)
        self.sampler = sampler
        self.s_churn = float(s_churn)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.s_noise = float(s_noise)
        self.multistep_ts = list(multistep) if multistep else [0, self.steps // 2]

    def _gammas(self, sigmas: np.ndarray) -> np.ndarray:
        """The per-step churn factor."""
        n = len(sigmas) - 1
        gam = np.zeros(n)
        for i in range(n):
            if self.s_tmin <= sigmas[i] <= self.s_tmax:
                gam[i] = min(self.s_churn / n, 2 ** 0.5 - 1)
        return gam

    def run(self, net_module, net: Callable, latents: torch.Tensor,
            draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
        sigma_min = max(self.sigma_min, net_module.sigma_min)
        sigma_max = min(self.sigma_max, net_module.sigma_max)
        rho, steps, kind, device = self.rho, self.steps, self.sampler, latents.device

        def denoise(x, sigma):
            x0 = net(x, sigma)
            return torch.clamp(x0, -1.0, 1.0) if self.clip_denoised else x0

        if kind == "onestep":
            x0 = denoise(latents * sigma_max, _f32(sigma_max, device))
            return torch.clamp(x0, -1.0, 1.0)
        if kind == "multistep":
            return self._multistep(denoise, latents, draw, sigma_min, sigma_max)

        sigmas = get_sigmas_karras(steps + 1 if kind == "progdist" else steps, sigma_min,
                                   sigma_max, rho)
        if kind == "progdist":
            sigmas = sigmas[:-1]  # no trailing zero
        x = latents * sigma_max

        if kind in ("euler", "progdist"):
            per = _tables({"sigma": sigmas[:-1], "dt": np.diff(sigmas)}, device)
            for i in range(len(sigmas) - 1):
                sigma = per["sigma"][i]
                d = (x - denoise(x, sigma)) / sigma
                x = x + d * per["dt"][i]
            return torch.clamp(x, -1.0, 1.0)

        if kind == "ancestral":
            s_from, s_to = sigmas[:-1], sigmas[1:]
            sigma_up = np.sqrt(np.maximum(s_to ** 2 * (s_from ** 2 - s_to ** 2) / s_from ** 2,
                                          0.0))
            sigma_down = np.sqrt(np.maximum(s_to ** 2 - sigma_up ** 2, 0.0))
            per = _tables({"sigma": s_from, "dt": sigma_down - s_from, "up": sigma_up}, device)
            for i in range(len(s_from)):
                sigma = per["sigma"][i]
                d = (x - denoise(x, sigma)) / sigma
                x = x + d * per["dt"][i]
                x = x + draw(i) * per["up"][i]
            return torch.clamp(x, -1.0, 1.0)

        if kind == "heun":
            gam = self._gammas(sigmas)
            sigma_hat = sigmas[:-1] * (gam + 1)
            churn = np.sqrt(np.maximum(sigma_hat ** 2 - sigmas[:-1] ** 2, 0.0))
            # Every step but the last (to sigma 0) takes the Heun correction;
            # the last is the denoised value itself.
            per = _tables({"sigma_hat": sigma_hat[:-1], "churn": churn[:-1],
                           "sigma_next": sigmas[1:-1]}, device)
            for i in range(len(sigma_hat) - 1):
                s_hat, s_next = per["sigma_hat"][i], per["sigma_next"][i]
                x = x + draw(i) * self.s_noise * per["churn"][i]
                d = (x - denoise(x, s_hat)) / s_hat
                dt = s_next - s_hat
                x_2 = x + d * dt
                d_2 = (x_2 - denoise(x_2, s_next)) / s_next
                x = x + (d + d_2) / 2 * dt
            last = _tables({"hat": sigma_hat[-1:], "churn": churn[-1:]}, device)
            x = x + draw(len(sigma_hat) - 1) * self.s_noise * last["churn"][0]
            x = denoise(x, last["hat"][0])
            return torch.clamp(x, -1.0, 1.0)

        if kind == "dpm":
            gam = self._gammas(sigmas)
            s_cur, s_next = sigmas[:-1], sigmas[1:]
            sigma_hat = s_cur * (gam + 1)
            churn = np.sqrt(np.maximum(sigma_hat ** 2 - s_cur ** 2, 0.0))
            # The midpoint on a rho = 3 Karras interpolation.
            sigma_mid = ((sigma_hat ** (1 / 3) + s_next ** (1 / 3)) / 2) ** 3
            per = _tables({"sigma_hat": sigma_hat, "churn": churn, "sigma_mid": sigma_mid,
                           "dt_1": sigma_mid - sigma_hat, "dt_2": s_next - sigma_hat}, device)
            for i in range(len(s_cur)):
                s_hat, s_mid = per["sigma_hat"][i], per["sigma_mid"][i]
                x = x + draw(i) * self.s_noise * per["churn"][i]
                d = (x - denoise(x, s_hat)) / s_hat
                x_2 = x + d * per["dt_1"][i]
                d_2 = (x_2 - denoise(x_2, s_mid)) / s_mid
                x = x + d_2 * per["dt_2"][i]
            return torch.clamp(x, -1.0, 1.0)

        raise ValueError(f"unknown consistency sampler '{kind}'")

    def _multistep(self, denoise, latents, draw, sigma_min: float, sigma_max: float):
        """Stochastic-iterative multistep: denoise, then renoise to the next
        boundary of the multistep subsequence; a last denoise."""
        rho, steps = self.rho, self.steps
        t_max_rho = sigma_max ** (1 / rho)
        t_min_rho = sigma_min ** (1 / rho)
        ts = np.asarray(self.multistep_ts, dtype=np.float64)
        t_cur = (t_max_rho + ts[:-1] / (steps - 1) * (t_min_rho - t_max_rho)) ** rho
        t_next = (t_max_rho + ts[1:] / (steps - 1) * (t_min_rho - t_max_rho)) ** rho
        t_next = np.clip(t_next, sigma_min, sigma_max)
        noise_coef = np.sqrt(np.maximum(t_next ** 2 - sigma_min ** 2, 0.0))
        per = _tables({"t": t_cur, "noise_coef": noise_coef}, latents.device)
        x = latents * sigma_max
        for i in range(len(t_cur)):
            x0 = denoise(x, per["t"][i])
            x = x0 + per["noise_coef"][i] * draw(i)
        t_last = float(np.clip((t_max_rho + ts[-1] / (steps - 1) * (t_min_rho - t_max_rho)) ** rho,
                               sigma_min, sigma_max))
        return denoise(x, _f32(t_last, latents.device))
