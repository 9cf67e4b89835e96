"""Super-resolution conditioning: the low-resolution image concatenated to
the model input, with Gaussian conditioning augmentation (GCA).

Counterpart of xdiffusion_tpu/layers/super_resolution.py (Imagen-style
cascades). `InputPreprocessor` upsamples the low-resolution conditioning
bilinearly to the model size (spatial), or repeats each of its frames
`skip` times along the frame axis and keeps the model's frames (temporal:
`skip` from `temporal_upsampling: frameskip_<skip>`, else the ratio of the
two sizes), scales it to [-1, 1], noises it by the
forward process to an augmentation timestep when GCA is on, writes that
timestep into the context (the caller's dict, in place, as the JAX module
does: the score network reads it from the same context) and concatenates it
to x on the channel axis. `GaussianConditioningAugmentationToTimestep` is
the context head that adds the augmentation timestep's embedding to the
timestep embedding; its projection lives in the score network
(`make_projection`).

The augmentation timestep is, in order of precedence:
- context["augmentation_level"] (a fixed level in [0, 1]: int(steps *
  level) for a discrete schedule, with the product in fp32 as in JAX, the
  level itself for a continuous one; the cascade stages' sampling level);
- context["augmentation_timestep"], given by the caller;
- a draw of the scheduler's `sample_random_times` from
  context["preprocessor_generator"].
The noise is context["augmentation_noise"] when the caller injects it (the
parity tests hand in the JAX package's own draws), else a normal draw from
context["preprocessor_generator"], after the timestep's. The JAX package
draws both from context["preprocessor_rng"] inside its jitted programs; the
distributions are the same.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.embedding import TimestepEmbeddingProjection
from xdiffusion_tpu_torch.utils import normalize_to_neg_one_to_one


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """(..., h, w, C) -> (..., size, size, C) fp32, as `jax.image.resize(...,
    "bilinear")` computes it: half-pixel centres, and a triangle kernel
    widened by the scale when downsampling (its default antialiasing)."""
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    if (h, w) == (size, size):
        return images
    x = images.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, size, size, c)


class InputPreprocessor:
    """Low-resolution channel concat with optional GCA: spatial (4-D images,
    or 5-D videos resized frame by frame on their two trailing spatial
    axes) or temporal (5-D videos, frames repeated)."""

    def __init__(self, low_resolution_size: int, super_resolution_size: int,
                 context_input_key: str, apply_gaussian_conditioning_augmentation: bool,
                 is_spatial: bool = True, is_temporal: bool = False, **kwargs):
        assert bool(is_temporal) ^ bool(is_spatial)
        self.low_resolution_size = int(low_resolution_size)
        self.super_resolution_size = int(super_resolution_size)
        self.context_input_key = context_input_key
        self.apply_gca = bool(apply_gaussian_conditioning_augmentation)
        self.is_spatial = bool(is_spatial)
        if "temporal_upsampling" in kwargs:
            assert kwargs["temporal_upsampling"].startswith("frameskip")
            self.temporal_skip = int(kwargs["temporal_upsampling"].split("_")[1])
        elif is_temporal:
            assert self.super_resolution_size % self.low_resolution_size == 0
            self.temporal_skip = self.super_resolution_size // self.low_resolution_size

    def __call__(self, x: torch.Tensor, context: Dict, noise_scheduler=None,
                 **kwargs) -> torch.Tensor:
        low_res = context[self.context_input_key]  # [0, 1] pixels
        b = low_res.shape[0]
        if self.is_spatial:
            low_res_x0 = normalize_to_neg_one_to_one(
                resize_bilinear(low_res, self.super_resolution_size))
        else:
            low_res_x0 = normalize_to_neg_one_to_one(low_res.repeat_interleave(
                self.temporal_skip, dim=1)[:, :self.super_resolution_size].float())
        if self.apply_gca and noise_scheduler is not None:
            device = low_res_x0.device
            generator = context.get("preprocessor_generator")
            if "augmentation_level" in context:
                level = float(context["augmentation_level"])
                if noise_scheduler.continuous():
                    s = torch.full((b,), level, dtype=torch.float32, device=device)
                else:
                    step = int(np.float32(noise_scheduler.steps()) * np.float32(level))
                    s = torch.full((b,), step, dtype=torch.long, device=device)
            elif "augmentation_timestep" in context:
                s = context["augmentation_timestep"]
            else:
                if generator is None:
                    raise ValueError("InputPreprocessor: GCA draws its timesteps from "
                                     "context['preprocessor_generator']")
                s, _ = noise_scheduler.sample_random_times(b, generator)
            noise = context.get("augmentation_noise")
            if noise is None:
                if generator is None:
                    raise ValueError("InputPreprocessor: GCA draws its noise from "
                                     "context['preprocessor_generator']")
                noise = torch.randn(low_res_x0.shape, generator=generator, device=device)
            low_res_x0 = noise_scheduler.q_sample(
                low_res_x0, s, noise.to(device=device, dtype=low_res_x0.dtype))
            context["augmentation_timestep"] = s
        return torch.cat([x, low_res_x0.to(x.dtype)], dim=-1)


class GaussianConditioningAugmentationToTimestep:
    """Context head: timestep_embedding += projections["augmentation_timestep"](
    context["augmentation_timestep"]). The score network registers the
    projection that `make_projection` builds under that key."""

    projection_key = "augmentation_timestep"

    def __init__(self, num_features: int, time_embedding_mult: int, **kwargs):
        self.num_features = int(num_features)
        self.time_embedding_mult = int(time_embedding_mult)

    def make_projection(self) -> TimestepEmbeddingProjection:
        return TimestepEmbeddingProjection(self.num_features, self.time_embedding_mult)

    def __call__(self, context: Dict, projections: Dict) -> Dict:
        assert "timestep_embedding" in context
        assert "augmentation_timestep" in context
        new_context = dict(context)
        emb = projections[self.projection_key](context["augmentation_timestep"])
        new_context["timestep_embedding"] = context["timestep_embedding"] + emb
        return new_context
