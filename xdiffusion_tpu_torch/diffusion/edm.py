"""The EDM diffusion process and the VP, VE and EDM training losses.

Counterpart of xdiffusion_tpu/diffusion/edm.py: each loss draws a noise
level per example (uniform in t for VP, log-uniform for VE, log-normal for
EDM) and weights the denoising error of the preconditioned network
D(y + n, sigma); sampling runs the config's EDM sampler
(samplers/edm.py). Randomness comes from an explicit `torch.Generator`, or
is injected: `loss_on_batch` takes `sigma` and `noise` (unit normal, scaled
by sigma inside), `sample` takes `initial_noise` and
`context["sampling_noise"]`, one draw a step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config
from xdiffusion_tpu_torch.utils import (
    mean_flat,
    normalize_to_neg_one_to_one,
    resolve_device,
    unnormalize_to_zero_to_one,
)


class VPLoss:
    """sigma(t) with t ~ U(eps_t, 1), weight 1 / sigma^2."""

    def __init__(self, beta_d: float = 19.9, beta_min: float = 0.1, epsilon_t: float = 1e-5):
        self.beta_d = float(beta_d)
        self.beta_min = float(beta_min)
        self.epsilon_t = float(epsilon_t)

    def sigma(self, t):
        return torch.sqrt(torch.exp(0.5 * self.beta_d * t ** 2 + self.beta_min * t) - 1.0)

    def weight(self, sigma):
        return 1.0 / sigma ** 2

    def sample_sigma_weight(self, batch: int, generator: torch.Generator, device):
        u = torch.rand((batch,), generator=generator, device=device)
        sigma = self.sigma(1.0 + u * (self.epsilon_t - 1.0))
        return sigma, self.weight(sigma)


class VELoss:
    """Log-uniform sigma in [sigma_min, sigma_max], weight 1 / sigma^2."""

    def __init__(self, sigma_min: float = 0.02, sigma_max: float = 100.0):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def weight(self, sigma):
        return 1.0 / sigma ** 2

    def sample_sigma_weight(self, batch: int, generator: torch.Generator, device):
        u = torch.rand((batch,), generator=generator, device=device)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** u
        return sigma, self.weight(sigma)


class EDMLoss:
    """Log-normal sigma, weight (sigma^2 + sd^2) / (sigma sd)^2."""

    def __init__(self, P_mean: float = -1.2, P_std: float = 1.2, sigma_data: float = 0.5):
        self.P_mean = float(P_mean)
        self.P_std = float(P_std)
        self.sigma_data = float(sigma_data)

    def weight(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2

    def sample_sigma_weight(self, batch: int, generator: torch.Generator, device):
        n = torch.randn((batch,), generator=generator, device=device)
        sigma = torch.exp(n * self.P_std + self.P_mean)
        return sigma, self.weight(sigma)


class GaussianDiffusion_EDM:
    """Karras-EDM process over a preconditioned score network, on `device`
    (CUDA unless "cpu" is asked for)."""

    def __init__(self, config: DotConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        diff = config.diffusion
        self._net = instantiate_from_config(diff.score_network.to_dict())
        self._net.to(self.device).eval()
        self._loss = instantiate_from_config(diff.loss.to_dict())
        self._sampler = instantiate_from_config(diff.sampling.to_dict())
        # No context preprocessors or host prompt projection, as in the JAX
        # package.
        self._context_preprocessors = []
        self._host_prompt_projection = None

    # -- protocol ------------------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def score_network(self) -> torch.nn.Module:
        return self._net

    def importance_sampler(self):
        """None: noise levels come from the loss, as in the JAX package."""
        return None

    # -- training ------------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      timesteps: Optional[torch.Tensor] = None,
                      loss_weights: Optional[torch.Tensor] = None,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted denoising loss on a (B, H, W, C) batch in [0, 1];
        returns (loss, metrics). `generator` draws, in this order, the noise
        levels unless `sigma` gives them, the unit noise unless `noise` gives
        it, and the dropout masks unless `deterministic`. `timesteps` and
        `loss_weights` are the trainer's and unused, as in the JAX package."""
        def need_generator():
            if generator is None:
                raise ValueError("loss_on_batch: pass a generator for its random draws")
            return generator

        y = normalize_to_neg_one_to_one(images)
        if sigma is not None:
            sigma = torch.as_tensor(sigma, dtype=torch.float32, device=images.device)
            weight = self._loss.weight(sigma)
        else:
            sigma, weight = self._loss.sample_sigma_weight(images.shape[0], need_generator(),
                                                           images.device)
        expand = (-1,) + (1,) * (y.ndim - 1)
        unit = (noise if noise is not None else
                torch.randn(y.shape, generator=need_generator(), device=images.device))
        n = unit * sigma.reshape(expand)
        self._net.train(not deterministic)
        d_yn = self._net(y + n, sigma, class_labels=context.get("classes"),
                         generator=None if deterministic else need_generator())
        per_example = mean_flat(weight.reshape(expand) * (d_yn - y) ** 2)
        loss = per_example.mean()
        return loss, {"loss": loss, "mse_loss": loss, "vb_loss": torch.zeros_like(loss),
                      "timesteps": sigma, "loss_per_example": per_example.detach()}

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
        """(num_samples, H, W, C) samples in [0, 1] by the config's EDM sampler
        (or `sampler`). The sampler sets the steps: `num_sampling_steps` and
        `classifier_free_guidance` are taken and ignored, as in the JAX
        package. `generator` draws the latents and each step's noise; `initial_noise`
        and `context["sampling_noise"]` ((steps, *shape)) replace them.
        `context["classes"]` goes to a class-conditional network."""
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
        self._net.eval()
        classes = context.get("classes")

        def net(x, sigma):
            return self._net(x, sigma, class_labels=classes)

        def draw(i):
            if injected is not None:
                return injected[i]
            return torch.randn(shape, generator=generator, device=device)

        x = (sampler or self._sampler).run(self._net, net, latents, draw)
        return unnormalize_to_zero_to_one(x)
