"""The score-SDE diffusion process: denoising score matching in continuous
or discrete time, and predictor-corrector sampling.

Counterpart of `GaussianDiffusion_SDE` in xdiffusion_tpu/diffusion/sde.py.
The score network predicts epsilon; the score is -eps / std(t), with std
from the SDE's marginal (continuous) or from the discrete sqrt(1 - alpha-bar)
table at step int32(fp32(t) * (N - 1)) (discrete). Sampling walks
linspace(T, 1e-3, N) with the config's predictor-corrector step.
Randomness comes from an explicit `torch.Generator`, or is injected:
`loss_on_batch` takes `timesteps` and `noise`, `sample` takes
`initial_noise` and `context["sampling_noise"]`, the draws of every step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config, type_from_config
from xdiffusion_tpu_torch.layers.embedding import place_encoders
from xdiffusion_tpu_torch.sde.vpsde import step_index
from xdiffusion_tpu_torch.utils import (
    broadcast_from_left,
    mean_flat,
    normalize_to_neg_one_to_one,
    resolve_device,
    unnormalize_to_zero_to_one,
)

# The smallest training time and the last sampling time, as in the JAX package.
TRAIN_EPS = 1e-5
SAMPLE_EPS = 1e-3


class GaussianDiffusion_SDE:
    """Config-driven score-SDE process over a score network, on `device`
    (CUDA unless "cpu" is asked for)."""

    def __init__(self, config: DotConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        diff = config.diffusion
        self._continuous = bool(diff.continuous)
        self._likelihood_weighting = bool(diff.get("likelihood_weighting", False))
        sn_cfg = diff.score_network
        sn_cls = type_from_config(sn_cfg.to_dict())
        self._score_network = sn_cls(config=DotConfig(sn_cfg.params.to_dict()))
        self._score_network.to(self.device).eval()
        self._context_preprocessors = [
            instantiate_from_config(c) for c in diff.get("context_preprocessing", [])
        ]
        # Frozen text towers load on the process's device.
        place_encoders(self._context_preprocessors, self.device)
        self._sde = instantiate_from_config(diff.sde.to_dict())
        self._sampler = instantiate_from_config(diff.sampling.to_dict())
        self._host_prompt_projection = None

    # -- protocol ------------------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def sde(self):
        return self._sde

    def score_network(self) -> torch.nn.Module:
        return self._score_network

    def importance_sampler(self):
        """None: t ~ U(1e-5, T) in the loss, as in the JAX package."""
        return None

    # -- score ---------------------------------------------------------------

    def predict_score(self, x: torch.Tensor, t: torch.Tensor,
                      dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """score(x, t) = -eps(x, t) / std(t) for times t (B,) in [0, T]. The
        network drops with `dropout_generator` while it is in training mode."""
        if self._continuous:
            labels = t * 999.0
            std = self._sde.marginal_prob(torch.zeros_like(x), t)[1]
        else:
            labels = t * (self._sde.N - 1)
            std = self._sde._on("sqrt_1m_alphas_cumprod", x.device)[
                step_index(t, self._sde.N, 1.0)]
        context = {"timestep": labels}
        if dropout_generator is not None:
            context["dropout_generator"] = dropout_generator
        eps = self._score_network(x, context)
        return -eps / broadcast_from_left(std, x.shape)

    # -- training ------------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      timesteps: Optional[torch.Tensor] = None,
                      loss_weights: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Denoising score matching on a (B, H, W, C) batch in [0, 1]; returns
        (loss, metrics). `generator` draws, in this order, the times t ~
        U(1e-5, T) unless `timesteps` gives them, the noise unless `noise`
        gives it, and the dropout masks unless `deterministic`. The JAX
        package draws t and z from its own keys and takes no injection;
        `loss_weights` is ignored there too."""
        def need_generator():
            if generator is None:
                raise ValueError("loss_on_batch: pass a generator for its random draws")
            return generator

        b = images.shape[0]
        x_0 = normalize_to_neg_one_to_one(images)
        if timesteps is not None:
            t = timesteps.float()
        else:
            u = torch.rand((b,), generator=need_generator(), device=images.device)
            t = u * (self._sde.T - TRAIN_EPS) + TRAIN_EPS
        z = (noise if noise is not None else
             torch.randn(x_0.shape, generator=need_generator(), device=images.device))
        mean, std = self._sde.marginal_prob(x_0, t)
        std_b = broadcast_from_left(std, x_0.shape)
        x_t = mean + std_b * z
        self._score_network.train(not deterministic)
        score = self.predict_score(x_t, t, None if deterministic else need_generator())
        if not self._likelihood_weighting:
            losses = mean_flat(torch.square(score * std_b + z))
        else:
            g2 = self._sde.sde(torch.zeros_like(x_0), t)[1] ** 2
            losses = mean_flat(torch.square(score + z / std_b)) * g2
        loss = losses.mean()
        return loss, {"loss": loss, "mse_loss": loss, "vb_loss": torch.zeros_like(loss),
                      "timesteps": t, "loss_per_example": losses.detach()}

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
        """(num_samples, H, W, C) samples in [0, 1] after `num_sampling_steps`
        (default N) predictor-corrector steps. `generator` draws the prior
        sample and every step's noise; `initial_noise` and
        `context["sampling_noise"]` ((steps, draws per step, *shape): the
        corrector's draws, then the predictor's) replace them. Guidance is
        not part of the process, as in the JAX package."""
        context = dict(context or {})
        shape = self.sampling_shape(num_samples)
        n = int(num_sampling_steps or self._sde.N)
        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        injected = context.get("sampling_noise")
        if injected is not None:
            injected = torch.as_tensor(injected, dtype=torch.float32, device=device)
        timesteps = torch.from_numpy(np.linspace(self._sde.T, SAMPLE_EPS, n, dtype=np.float32))
        timesteps = timesteps.to(device)
        if initial_noise is not None:
            x = torch.as_tensor(initial_noise, dtype=torch.float32, device=device)
        else:
            x = self._sde.prior_sampling(shape, generator, device)
        self._score_network.eval()
        step = (sampler or self._sampler).build(self._sde, self.predict_score)
        for i in range(n):
            draws = iter(injected[i]) if injected is not None else None

            def draw():
                if draws is not None:
                    return next(draws)
                return torch.randn(shape, generator=generator, device=device)

            x = step(x, timesteps[i].expand(shape[0]), i == n - 1, draw)
        return unnormalize_to_zero_to_one(x)
