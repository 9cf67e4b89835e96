"""Sampler protocol and the shared model-evaluation helpers.

Counterpart of xdiffusion_tpu/samplers/base.py: classifier-free guidance
runs as one forward on a 2x batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from xdiffusion_tpu_torch.diffusion import PredictionType
from xdiffusion_tpu_torch.utils import dynamic_thresholding


def _merge_cfg_context(batch: int, context: Dict, unconditional_context: Dict) -> Dict:
    """Concatenates the batched tensor signals of both contexts."""
    merged = {}
    for key, value in context.items():
        uvalue = unconditional_context.get(key, value)
        if isinstance(value, torch.Tensor) and value.ndim >= 1 and value.shape[0] == batch:
            merged[key] = torch.cat([value, uvalue.expand_as(value)], dim=0)
        else:
            merged[key] = value
    return merged


def _guided(run, x: torch.Tensor, context: Dict, unconditional_context: Optional[Dict],
            classifier_free_guidance: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """`run(x, ctx)`'s outputs; with guidance, one run on the 2x batch and
    each output mixed as uncond + w * (cond - uncond)."""
    cfg = classifier_free_guidance
    if cfg is None or cfg < 0.0 or unconditional_context is None:
        return run(x, context)
    b = x.shape[0]
    outs = run(torch.cat([x, x], dim=0), _merge_cfg_context(b, context, unconditional_context))
    return tuple(t[b:] + cfg * (t[:b] - t[b:]) for t in outs)


def predict_epsilon(process, x: torch.Tensor, context: Dict,
                    unconditional_context: Optional[Dict],
                    classifier_free_guidance: Optional[float]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(prediction, variance, log_variance): a learned-sigma network's
    variance half is its log-variance, else the scheduler's fixed-large
    estimate. Under guidance the variance and the log-variance are each
    mixed with the same w, as the JAX package mixes them: neither is
    derived from the other after the mix."""

    def run(x_in, ctx):
        x_in = process.process_input(x_in, ctx)
        out = process.predict_score(x_in, ctx)
        if process.is_learned_sigma():
            pred, log_variance = out
            return pred, torch.exp(log_variance), log_variance
        variance, log_variance = process.noise_scheduler().variance_fixed_large(ctx, out.shape)
        return out, variance, log_variance

    return _guided(run, x, context, unconditional_context, classifier_free_guidance)


def predict_guided(process, x: torch.Tensor, context: Dict,
                   unconditional_context: Optional[Dict],
                   classifier_free_guidance: Optional[float]) -> torch.Tensor:
    """The network's prediction alone, guidance mixed as in
    `predict_epsilon`: for ODE samplers (rectified flow), whose schedulers
    have no reverse variance."""

    def run(x_in, ctx):
        return (process.predict_score(process.process_input(x_in, ctx), ctx),)

    return _guided(run, x, context, unconditional_context, classifier_free_guidance)[0]


def predict_x_hat(process, z_t: torch.Tensor, context: Dict,
                  unconditional_context: Optional[Dict],
                  classifier_free_guidance: Optional[float], clip_denoised: bool = True):
    """(x_hat, variance, log_variance, prediction), x_hat clipped to [-1, 1]
    (or dynamically thresholded when the config asks)."""
    pred, variance, log_variance = predict_epsilon(
        process, z_t, context, unconditional_context, classifier_free_guidance)
    sched = process.noise_scheduler()
    if process.prediction_type() == PredictionType.EPSILON:
        x_hat = sched.predict_x_from_epsilon(z=z_t, epsilon=pred, context=context)
    elif process.prediction_type() == PredictionType.V:
        x_hat = sched.predict_x_from_v(z=z_t, v=pred, context=context)
    else:
        raise NotImplementedError(
            f"Prediction type {process.prediction_type()} not supported here.")
    dt_cfg = process.dynamic_thresholding_config()
    if clip_denoised:
        if dt_cfg is not None and dt_cfg.enable:
            x_hat = dynamic_thresholding(x_hat, p=dt_cfg.p, c=dt_cfg.c)
        else:
            x_hat = torch.clamp(x_hat, -1.0, 1.0)
    return x_hat, variance, log_variance, pred


def continuous_step_context(process, num_steps: int) -> Dict[str, torch.Tensor]:
    """A continuous schedule's per-step tensors for the T = num_steps steps
    T-1 ... 0: step i at time t_i = i / T, stepping from logSNR(t_{i+1}) to
    logSNR(t_i); the times in fp32, built as the JAX package builds them."""
    sched = process.noise_scheduler()
    idx = np.arange(num_steps - 1, -1, -1, dtype=np.int32)
    t = idx.astype(np.float32)
    s_time, t_time = torch.from_numpy(t / num_steps), torch.from_numpy((t + 1.0) / num_steps)
    return {
        "timestep_idx": torch.from_numpy(idx),
        "is_last": torch.from_numpy(idx == 0),
        "timestep": s_time,
        "logsnr_s": sched.logsnr(s_time),
        "logsnr_t": sched.logsnr(t_time),
    }


class ReverseProcessSampler:
    """Single-step reverse-process sampler contract."""

    def step_context(self, process, num_steps: int) -> Dict[str, torch.Tensor]:
        """Per-step tensors with leading axis T, in loop order (entry 0 is
        the first update of x_T); `is_last` is a bool tensor."""
        raise NotImplementedError

    def p_sample(self, x, context, unconditional_context, process, generator,
                 classifier_free_guidance=None) -> torch.Tensor:
        """One reverse step x_t -> x_{t-1}."""
        raise NotImplementedError
