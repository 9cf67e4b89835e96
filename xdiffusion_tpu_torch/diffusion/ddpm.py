"""Gaussian diffusion process (DDPM), the sampling path.

Counterpart of `GaussianDiffusion_DDPM` in xdiffusion_tpu/diffusion/ddpm.py:
construction from a config, `predict_score`, `sampling_shape` and
`sample`. The score network is an `nn.Module` that holds its parameters;
randomness comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config, type_from_config
from xdiffusion_tpu_torch.diffusion import PredictionType, prediction_type_from_config
from xdiffusion_tpu_torch.diffusion.sampling import build_sample_loop
from xdiffusion_tpu_torch.importance_sampling import UniformSampler
from xdiffusion_tpu_torch.utils import resolve_device


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
        for unported in ("sde", "latent_encoder"):
            if diff.get(unported) is not None:
                raise NotImplementedError(f"diffusion.{unported} is not ported yet")
        if "super_resolution" in config:
            raise NotImplementedError("super-resolution cascades are not ported yet")

        sn_cfg = diff.score_network
        sn_cls = type_from_config(sn_cfg.to_dict())
        self._score_network = sn_cls(config=DotConfig(sn_cfg.params.to_dict()))
        self._score_network.to(self.device).eval()
        self._is_learned_sigma = bool(sn_cfg.params.is_learned_sigma)

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

        sampling = diff.get("sampling")
        if sampling is not None and "target" in sampling:
            self._reverse_process_sampler = instantiate_from_config(sampling.to_dict())
        else:
            from xdiffusion_tpu_torch.samplers.ancestral import AncestralSampler

            self._reverse_process_sampler = AncestralSampler()

    # -- protocol accessors ------------------------------------------------

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

    # -- sampling ------------------------------------------------------------

    def sampling_shape(self, num_samples: int) -> Tuple[int, ...]:
        sampling = self._config.diffusion.sampling
        s = sampling.output_spatial_size
        spatial = [s[0], s[1]] if isinstance(s, list) else [s, s]
        if "output_frames" in sampling:
            raise NotImplementedError("video sampling is not ported yet")
        return (num_samples, spatial[0], spatial[1], sampling.output_channels)

    @torch.inference_mode()
    def sample(self, num_samples: int = 16, context: Optional[Dict] = None,
               classifier_free_guidance: Optional[float] = None,
               num_sampling_steps: Optional[int] = None, sampler=None,
               initial_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(num_samples, H, W, C) samples in [0, 1] on the process's device.

        `generator` (on that device) draws the initial and per-step noise;
        `initial_noise` and `context["sampling_noise"]` replace them."""
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
            return {k: v for k, v in ctx.items()
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
