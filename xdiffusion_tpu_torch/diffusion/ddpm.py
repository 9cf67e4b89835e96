"""Gaussian diffusion process (DDPM): sampling and the training loss.

Counterpart of `GaussianDiffusion_DDPM` in xdiffusion_tpu/diffusion/ddpm.py:
construction from a config, `predict_score`, `sampling_shape`, `sample` and
`loss_on_batch`, for image (B, H, W, C) and video (B, F, H, W, C) samples.
The score network is an `nn.Module` that holds its parameters; randomness
comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config, type_from_config
from xdiffusion_tpu_torch.diffusion import PredictionType, prediction_type_from_config
from xdiffusion_tpu_torch.diffusion.sampling import build_sample_loop
from xdiffusion_tpu_torch.importance_sampling import UniformSampler
from xdiffusion_tpu_torch.scheduler import elementwise_loss
from xdiffusion_tpu_torch.utils import (
    mean_flat,
    normalize_to_neg_one_to_one,
    prob_mask_like,
    resolve_device,
)


class GaussianDiffusion_DDPM:
    """Config-driven diffusion process over a score network.

    Runs on `device`: CUDA when none is given (raising if there is no CUDA
    device), the CPU only when asked for."""

    def __init__(self, config: DotConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        diff = config.diffusion
        self._prediction_type = prediction_type_from_config(diff.parameterization)
        if diff.get("latent_encoder") is not None:
            raise NotImplementedError("diffusion.latent_encoder is not ported yet")
        if "super_resolution" in config:
            raise NotImplementedError("super-resolution cascades are not ported yet")

        sn_cfg = diff.score_network
        sn_cls = type_from_config(sn_cfg.to_dict())
        self._score_network = sn_cls(config=DotConfig(sn_cfg.params.to_dict()))
        self._score_network.to(self.device).eval()
        self._is_learned_sigma = bool(sn_cfg.params.is_learned_sigma)
        if int(sn_cfg.params.get("num_experts", 0) or 0) > 1:
            raise NotImplementedError("mixture-of-experts score networks are not ported yet")

        self._noise_scheduler = instantiate_from_config(
            diff.noise_scheduler.to_dict()).to(self.device)
        is_cfg = diff.noise_scheduler.params.get("importance_sampler")
        if is_cfg is not None and "target" in is_cfg:
            self._importance_sampler = instantiate_from_config(is_cfg.to_dict())
        else:
            self._importance_sampler = UniformSampler(self._noise_scheduler.steps())

        self._context_preprocessors = [
            instantiate_from_config(c) for c in diff.get("context_preprocessing", [])
        ]
        ip_cfg = diff.get("input_preprocessing")
        self._input_preprocessor = (
            instantiate_from_config(ip_cfg.to_dict()) if ip_cfg is not None else None)

        cfg_block = diff.get("classifier_free_guidance")
        self._unconditional_context_adapter = (
            instantiate_from_config(cfg_block.unconditional_context.to_dict())
            if cfg_block is not None else None)
        self._unconditional_guidance_probability = (
            float(cfg_block.unconditional_guidance_probability)
            if cfg_block is not None else 0.0)
        self._cfg_signals = list(cfg_block.signals) if cfg_block is not None else []

        sampling = diff.get("sampling")
        if sampling is not None and "target" in sampling:
            self._reverse_process_sampler = instantiate_from_config(sampling.to_dict())
        else:
            from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler

            self._reverse_process_sampler = AncestralSampler()

        # Optional SDE shell (rectified flow).
        sde_cfg = diff.get("sde")
        self._sde = (instantiate_from_config(sde_cfg.to_dict())
                     if sde_cfg is not None else None)

    # -- protocol accessors ------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def score_network(self) -> torch.nn.Module:
        return self._score_network

    def noise_scheduler(self):
        return self._noise_scheduler

    def importance_sampler(self):
        return self._importance_sampler

    def prediction_type(self) -> PredictionType:
        return self._prediction_type

    def is_learned_sigma(self) -> bool:
        return self._is_learned_sigma

    def sde(self):
        return self._sde

    def dynamic_thresholding_config(self):
        return self._config.diffusion.get("dynamic_thresholding")

    # -- forward -------------------------------------------------------------

    def process_input(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        if self._input_preprocessor is None:
            return x
        return self._input_preprocessor(x=x, context=context,
                                        noise_scheduler=self._noise_scheduler)

    def predict_score(self, x: torch.Tensor, context: Dict) -> torch.Tensor:
        return self._score_network(x, context)

    def preprocess_context(self, context: Dict) -> Dict:
        for preprocessor in self._context_preprocessors:
            context = preprocessor(context)
        return context

    def unconditional_context(self, context: Dict) -> Optional[Dict]:
        if self._unconditional_context_adapter is None:
            return None
        out = self._unconditional_context_adapter(context)
        return out if isinstance(out, dict) else None

    # -- training loss -------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      timesteps: Optional[torch.Tensor] = None,
                      loss_weights: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training objective on an image (B, H, W, C) or video (B, F, H, W, C)
        batch in [0, 1], differentiable in the score network's parameters.
        Returns (loss, metrics). A context `video_mask` (B, F) keeps the
        frames it marks False at their clean values.

        `generator` (on the process's device) draws, in this order, the
        timesteps unless `timesteps` is given, the noise unless `noise` is
        given, the classifier-free-guidance drop mask, and the dropout masks.
        `deterministic=True` puts the network in eval mode (no dropout);
        otherwise it trains, and drops with `generator`."""
        b = images.shape[0]
        context = dict(context)

        def need_generator():
            if generator is None:
                raise ValueError("loss_on_batch: pass a generator for its random draws")
            return generator

        z_0 = normalize_to_neg_one_to_one(images)
        if timesteps is not None:
            t = timesteps
            weights = (loss_weights if loss_weights is not None
                       else torch.ones((b,), dtype=torch.float32, device=images.device))
        else:
            t, weights = self._noise_scheduler.sample_random_times(b, need_generator())
        if self._noise_scheduler.continuous():
            raise NotImplementedError("continuous-time schedules are not ported yet")
        context["timestep"] = t

        epsilon = (noise if noise is not None else
                   torch.randn(z_0.shape, generator=need_generator(), dtype=z_0.dtype,
                               device=z_0.device))
        x_t = self._noise_scheduler.q_sample(x_start=z_0, t=t, noise=epsilon)
        if "video_mask" in context:
            # Masked video diffusion: conditioning frames (mask False) keep
            # their clean values, and networks that splice observed frames
            # at their input read them from context["x0"].
            mask = context["video_mask"][:, :x_t.shape[1], None, None, None].bool()
            x_t = torch.where(mask, x_t, z_0)
            context["x0"] = z_0

        # Training-time CFG: drop conditioning signals to their unconditional
        # values with the configured probability.
        if (self._unconditional_guidance_probability > 0.0
                and self._unconditional_context_adapter is not None):
            uncond = self.unconditional_context(context)
            mask = prob_mask_like((b,), self._unconditional_guidance_probability,
                                  need_generator(), images.device)
            for key in self._cfg_signals:
                if key not in context or key not in uncond:
                    continue
                cond_sig, uncond_sig = context[key], uncond[key]
                if not isinstance(cond_sig, torch.Tensor):
                    continue
                m = mask.reshape((b,) + (1,) * (cond_sig.ndim - 1))
                context[key] = torch.where(m, uncond_sig, cond_sig)

        network = self._score_network
        network.train(not deterministic)
        if not deterministic:
            context["dropout_generator"] = need_generator()
        model_prediction = self.predict_score(self.process_input(x_t, context), context)

        if self._prediction_type == PredictionType.EPSILON:
            target = epsilon
        elif self._prediction_type == PredictionType.V:
            target = self._noise_scheduler.predict_v_from_x_and_epsilon(
                x=z_0, epsilon=epsilon, t=t)
        elif self._prediction_type == PredictionType.RECTIFIED_FLOW:
            target = z_0 - epsilon
        else:
            raise NotImplementedError(f"Prediction type {self._prediction_type} not implemented.")

        loss_type = getattr(self._noise_scheduler, "loss_type", "l2")
        mse_loss = mean_flat(elementwise_loss(loss_type, model_prediction, target))
        vb_loss = torch.zeros_like(mse_loss)
        objective = ((mse_loss + vb_loss) * weights).mean()
        metrics = {
            "loss": objective,
            "mse_loss": mse_loss.mean(),
            "vb_loss": vb_loss.mean(),
            "timesteps": t,
            "loss_per_example": (mse_loss + vb_loss).detach(),
        }
        return objective, metrics

    # -- sampling ------------------------------------------------------------

    def sampling_shape(self, num_samples: int) -> Tuple[int, ...]:
        sampling = self._config.diffusion.sampling
        s = sampling.output_spatial_size
        spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        if "output_frames" in sampling:
            return (num_samples, sampling.output_frames, spatial[0], spatial[1],
                    sampling.output_channels)
        return (num_samples, spatial[0], spatial[1], sampling.output_channels)

    @torch.inference_mode()
    def sample(self, num_samples: int = 16, context: Optional[Dict] = None,
               classifier_free_guidance: Optional[float] = None,
               num_sampling_steps: Optional[int] = None, sampler=None,
               initial_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(num_samples, H, W, C) or, for a video config, (num_samples, F, H,
        W, C) samples in [0, 1] on the process's device.

        `generator` (on that device) draws the initial and per-step noise;
        `initial_noise` and `context["sampling_noise"]` replace them. Tensors
        that the context preprocessors make on the host (text embeddings)
        move to the device once, before the loop."""
        context = dict(context or {})
        steps = (num_sampling_steps if num_sampling_steps is not None
                 else self._noise_scheduler.steps())
        unconditional_context = None
        if classifier_free_guidance is not None:
            unconditional_context = self.unconditional_context(context)
            if unconditional_context is not None:
                unconditional_context = self.preprocess_context(unconditional_context)
        context = self.preprocess_context(context)

        def sanitize(ctx):
            if ctx is None:
                return None
            return {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                    for k, v in ctx.items()
                    if not isinstance(v, (str, list, tuple)) or k == "shape"}

        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        sample_fn = build_sample_loop(
            process=self, shape=self.sampling_shape(num_samples),
            num_sampling_steps=steps,
            sampler=sampler if sampler is not None else self._reverse_process_sampler,
            classifier_free_guidance=classifier_free_guidance,
        )
        return sample_fn(generator, sanitize(context), sanitize(unconditional_context),
                         initial_noise)
