"""Imagen-style cascaded diffusion: a base model and super-resolution stages.

Counterpart of xdiffusion_tpu/diffusion/cascade.py. Each stage is a DDPM
process built from its own YAML (`diffusion_cascade.cascade_layer_<k>.config`,
a path relative to the working directory, or to `config_dir` when one is
given and the file is there, as in JAX). Training sums the stages' losses,
each stage on the batch resized to its model size and a super-resolution
stage conditioned on the batch resized to its low resolution (the JAX
cascade's `_resize`: `resize_bilinear`, antialiased like
`jax.image.resize`), with `stage_<k>_loss`
metrics. A video batch (5-D) is refused with the JAX cascade's
`ValueError`: its `_resize` unpacks a 4-D shape, so the Imagen-Video
cascade does not train there either. Sampling chains the stages: stage k's
samples are stage k+1's `super_resolution.conditioning_key` (the video
cascade: base frames, then the temporal stage's repeated frames, then the
spatial stage's resize).

The stages' score networks sit in one `nn.ModuleDict` under `stage_<k>`
(`score_network()`), so one optimizer, one EMA and one checkpoint hold them
all, as the JAX package's params dict {"stage_1": ..., "stage_2": ...}
does; a flax tree flattened as `stage_<k>/<path>` maps onto it
mechanically (weights.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from xdiffusion_tpu_torch.config import DotConfig, load_yaml
from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
from xdiffusion_tpu_torch.layers.super_resolution import resize_bilinear
from xdiffusion_tpu_torch.utils import resolve_device


class GaussianDiffusionCascade:
    """The cascade's stages, on `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, config: DotConfig, config_dir: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._config = config
        self._layers: List[GaussianDiffusion_DDPM] = []
        k = 1
        while f"cascade_layer_{k}" in config.diffusion_cascade:
            path = config.diffusion_cascade[f"cascade_layer_{k}"].config
            if config_dir and not os.path.isabs(path):
                candidate = os.path.join(config_dir, path)
                if os.path.exists(candidate):
                    path = candidate
            self._layers.append(GaussianDiffusion_DDPM(load_yaml(path), device=self.device))
            k += 1
        assert self._layers, "cascade has no stages"
        self._networks = torch.nn.ModuleDict(
            {f"stage_{i + 1}": layer.score_network() for i, layer in enumerate(self._layers)})
        # The trainer's prompt path: the stages' host-side preprocessors.
        self._context_preprocessors = [p for layer in self._layers
                                       for p in layer._context_preprocessors]
        self._host_prompt_projection = None

    # -- protocol --------------------------------------------------------------

    def config(self) -> DotConfig:
        return self._config

    def models(self) -> List[GaussianDiffusion_DDPM]:
        return list(self._layers)

    def score_network(self) -> torch.nn.ModuleDict:
        return self._networks

    def importance_sampler(self):
        return self._layers[0].importance_sampler()

    def classifier_free_guidance(self) -> float:
        return self._layers[0].classifier_free_guidance()

    def preprocess_context(self, context: Dict) -> Dict:
        """Prompt strings -> tensors by each stage's preprocessors in turn (a
        later stage keeps what an earlier one made: its tokens)."""
        for layer in self._layers:
            context = layer.preprocess_context(context)
        return context

    # -- training --------------------------------------------------------------

    def loss_on_batch(self, images: torch.Tensor, context: Dict,
                      timesteps: Optional[torch.Tensor] = None,
                      loss_weights: Optional[torch.Tensor] = None,
                      deterministic: bool = False,
                      generator: Optional[torch.Generator] = None,
                      stage_noise: Optional[Sequence[Dict]] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The sum of the stages' losses on `images` (B, H, W, C) in [0, 1] at
        the last stage's resolution. Each stage draws from `generator` in
        turn; as in the JAX cascade, `timesteps` and `loss_weights` are not
        passed on. `stage_noise[k]`, when given, holds stage k's injected
        `timesteps`, `noise` and context entries (`augmentation_timestep`,
        `augmentation_noise`)."""
        if images.ndim != 4:
            raise ValueError(f"too many values to unpack (expected 4): the cascade trains on "
                             f"(B, H, W, C) images, not {tuple(images.shape)}")
        total = 0.0
        metrics = {}
        for i, layer in enumerate(self._layers):
            cfg = layer.config()
            layer_ctx = dict(context)
            if "super_resolution" in cfg:
                sr = cfg.super_resolution
                layer_ctx[sr.conditioning_key] = resize_bilinear(images, sr.low_resolution_size)
            inject = dict(stage_noise[i]) if stage_noise is not None else {}
            layer_ctx.update(inject.pop("context", {}))
            loss, m = layer.loss_on_batch(resize_bilinear(images, cfg.data.image_size), layer_ctx,
                                          deterministic=deterministic, generator=generator,
                                          **inject)
            total = total + loss
            metrics[f"stage_{i + 1}_loss"] = m["loss"]
        b = images.shape[0]
        zeros = torch.zeros((b,), device=images.device)
        return total, {"loss": total, "mse_loss": total, "vb_loss": torch.zeros_like(total),
                       "timesteps": zeros.long(), "loss_per_example": zeros, **metrics}

    # -- sampling --------------------------------------------------------------

    @torch.inference_mode()
    def sample(self, num_samples: int = 16, context: Optional[Dict] = None,
               classifier_free_guidance: Optional[float] = None,
               num_sampling_steps: Optional[int] = None, sampler=None,
               initial_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               stage_noise: Optional[Sequence[Dict]] = None) -> torch.Tensor:
        """Stage 1's samples condition stage 2, and so on; returns the last
        stage's samples in [0, 1]. `sampler` and `initial_noise` are taken
        and ignored, as in the JAX cascade: each stage samples with its own
        sampler. `stage_noise[k]`, when given, holds stage k's injected
        `initial_noise` and context entries (`sampling_noise`,
        `sampling_augmentation_noise`)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        output = None
        for i, layer in enumerate(self._layers):
            layer_ctx = dict(context or {})
            inject = dict(stage_noise[i]) if stage_noise is not None else {}
            layer_ctx.update(inject.pop("context", {}))
            if output is not None:
                layer_ctx[layer.config().super_resolution.conditioning_key] = output
            output = layer.sample(num_samples=num_samples, context=layer_ctx,
                                  classifier_free_guidance=classifier_free_guidance,
                                  num_sampling_steps=num_sampling_steps,
                                  generator=generator, **inject)
        return output
