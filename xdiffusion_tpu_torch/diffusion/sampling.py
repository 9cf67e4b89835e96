"""The sampling loop: one Python loop over the denoising steps.

Counterpart of xdiffusion_tpu/diffusion/sampling.py (a `lax.scan` there).
The per-step context (timesteps, logSNR pairs) is built on the device once
before the loop; the last-step flag is a host value, so no step waits on
the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from xdiffusion_tpu_torch.utils import unnormalize_to_zero_to_one

# Per-step keys broadcast to (B,) (the context protocol's batched signals).
_BATCHED_KEYS = ("timestep", "logsnr_s", "logsnr_t")
# Injected per-step draws (T, ...) -> the key each step's slice takes.
_OVERRIDES = {"sampling_noise": "sampling_noise",
              "sampling_augmentation_noise": "augmentation_noise",
              "reconstruction_noise": "reconstruction_noise"}


def build_sample_loop(process, shape, num_sampling_steps: int, sampler,
                      classifier_free_guidance: Optional[float] = None,
                      unnormalize: bool = True) -> Callable:
    """Returns `sample_fn(generator, context, unconditional_context,
    initial_noise)` -> samples in [0, 1] (with `unnormalize=False`, the final
    x as the sampler leaves it: a latent process's latents); `shape` is the
    full batched NHWC (or, for video, NFHWC) output shape.

    `context["sampling_noise"]`, of shape (T, *shape), replaces the noise a
    stochastic sampler would draw at each of the T steps, and
    `context["sampling_augmentation_noise"]`, (T, ...), the noise a
    super-resolution stage's conditioning augmentation would draw (of the
    doubled batch under guidance). Otherwise each step's augmentation draws
    from `generator`, the conditional and unconditional halves together, as
    in the JAX package, where both share the step's key.
    `context["reconstruction_noise"]`, (T, *x_a.shape), replaces the noise
    that reconstruction guidance (samplers/ancestral.py) draws at each step
    to noise the conditioning frames `x_a`.

    The video splice: with `context["video_mask"]` (B, >= F) and
    `context["x0"]` (B, F, H, W, C), the frames the mask marks False are set
    to x0 before and after every step (observed frames stay pinned)."""
    step_ctx = sampler.step_context(process, num_sampling_steps)
    batch = shape[0]
    # A super-resolution stage's input preprocessor augments its conditioning.
    augments = getattr(getattr(process, "_input_preprocessor", None), "apply_gca", False)

    def sample_fn(generator: Optional[torch.Generator] = None,
                  context: Optional[Dict] = None,
                  unconditional_context: Optional[Dict] = None,
                  initial_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = process.device
        context = dict(context or {})
        overrides = {key: context.pop(key, None) for key in _OVERRIDES}
        if unconditional_context is not None:  # the steps draw with the conditional context
            unconditional_context = {k: v for k, v in unconditional_context.items()
                                     if k not in _OVERRIDES}
        overrides = {_OVERRIDES[k]: torch.as_tensor(v, dtype=torch.float32, device=device)
                     for k, v in overrides.items() if v is not None}
        splice = None
        if "video_mask" in context and "x0" in context:
            mask = torch.as_tensor(context["video_mask"], device=device).bool()
            splice = (mask[:, :shape[1], None, None, None],
                      torch.as_tensor(context["x0"], dtype=torch.float32, device=device))
        if initial_noise is not None:
            x = torch.as_tensor(initial_noise, dtype=torch.float32, device=device)
        else:
            x = torch.randn(shape, generator=generator, device=device)
        per_step = {k: v.to(device) for k, v in step_ctx.items() if k != "is_last"}
        is_last = step_ctx["is_last"].tolist()
        for i in range(len(is_last)):
            ctx = dict(context)
            uctx = dict(unconditional_context) if unconditional_context is not None else None
            for k, v in per_step.items():
                val = v[i].expand(batch) if k in _BATCHED_KEYS else v[i]
                ctx[k] = val
                if uctx is not None:
                    uctx[k] = val
            ctx["is_last"] = is_last[i]
            if augments:
                ctx["preprocessor_generator"] = generator
            for key, values in overrides.items():
                ctx[key] = values[i]
            if splice is not None:
                x = torch.where(splice[0], x, splice[1])
            x = sampler.p_sample(x, ctx, uctx, process, generator,
                                 classifier_free_guidance=classifier_free_guidance)
            if splice is not None:
                x = torch.where(splice[0], x, splice[1])
        return unnormalize_to_zero_to_one(x) if unnormalize else x

    return sample_fn
