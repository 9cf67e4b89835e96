"""The consistency and progressive-distillation (EMA rate, N scales) schedule.

Counterpart of `create_ema_and_scales_fn` in xdiffusion_tpu/layers/ema.py:
host-side numpy, step -> (target EMA rate, number of scales), with the fixed
and adaptive target EMA and the fixed, progressive and progdist scale modes.
The EMA update itself is `train_step.update_ema`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def create_ema_and_scales_fn(
    target_ema_mode: str,
    start_ema: float,
    total_steps: int,
    scale_mode: str = "fixed",
    start_scales: float = 0,
    end_scales: float = 0,
    distill_steps_per_iter: int = 0,
    **_ignored,
) -> Callable[[int], Tuple[float, int]]:
    """step -> (target_ema_rate, num_scales) (Consistency Models, Sec. 5;
    the progdist mode of progressive distillation)."""
    assert target_ema_mode in ("fixed", "adaptive")
    assert scale_mode in ("fixed", "progressive", "progdist")

    def ema_and_scales_fn(step: int) -> Tuple[float, int]:
        if target_ema_mode == "fixed" and scale_mode == "fixed":
            target_ema = start_ema
            scales = start_scales
        elif scale_mode == "progressive":
            scales = np.ceil(
                np.sqrt((step / total_steps) * ((end_scales + 1) ** 2 - start_scales ** 2)
                        + start_scales ** 2) - 1
            ).astype(np.int64)
            scales = np.maximum(scales, 1)
            if target_ema_mode == "adaptive":
                c = -np.log(start_ema) * start_scales
                target_ema = float(np.exp(-c / scales))
            else:
                target_ema = start_ema
            scales = scales + 1
        else:  # fixed + progdist
            assert distill_steps_per_iter > 0
            distill_stage = step // distill_steps_per_iter
            scales = start_scales // (2 ** distill_stage)
            scales = np.maximum(scales, 2)
            sub_stage = np.maximum(step - distill_steps_per_iter * (np.log2(start_scales) - 1), 0)
            sub_stage = sub_stage // (distill_steps_per_iter * 2)
            sub_scales = 2 // (2 ** sub_stage)
            sub_scales = np.maximum(sub_scales, 1)
            scales = np.where(scales == 2, sub_scales, scales)
            target_ema = 1.0
        return float(target_ema), int(scales)

    return ema_and_scales_fn
