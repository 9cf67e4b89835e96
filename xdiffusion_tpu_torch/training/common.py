"""Shared training-loop utilities: sample grids, metric logging, and whether
a model takes text.

Counterpart of xdiffusion_tpu/training/common.py, and of
`_is_text_conditional` of xdiffusion_tpu/training/image/train.py, which the
video trainer and the video sampling CLI share. Metrics go to
<output_path>/metrics.jsonl, to TensorBoard events under
<output_path>/tensorboard (tensorboard.py; `XDIFFUSION_TENSORBOARD=0` turns
them off, as in the JAX package) and, every `print_every` steps, to the
console.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from xdiffusion_tpu_torch.sample import save_image_grid  # noqa: F401  (re-exported)


class MetricsLogger:
    """JSONL step metrics, their TensorBoard scalars and the sample grids as
    TensorBoard images, and console progress."""

    def __init__(self, output_path: str, print_every: int = 100):
        os.makedirs(output_path, exist_ok=True)
        self._file = open(os.path.join(output_path, "metrics.jsonl"), "a")
        self._print_every = print_every
        self._t0 = time.time()
        self._last_print = self._t0
        self._last_step = 0
        self._tb = None
        if os.environ.get("XDIFFUSION_TENSORBOARD", "1") != "0":
            from xdiffusion_tpu_torch.tensorboard import TensorBoardWriter

            self._tb = TensorBoardWriter(os.path.join(output_path, "tensorboard"))

    def log(self, step: int, metrics: Dict[str, float]):
        """Writes one record; tensor values are read to the host (a sync)."""
        values = {k: float(v.item() if isinstance(v, torch.Tensor) else v)
                  for k, v in metrics.items()}
        record = {"step": step, "time": time.time() - self._t0, **values}
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if step % self._print_every == 0:
            now = time.time()
            sps = (step - self._last_step) / max(now - self._last_print, 1e-9)
            self._last_print, self._last_step = now, step
            items = " ".join(f"{k}={v:.4g}" for k, v in values.items())
            print(f"step {step} | {sps:.2f} steps/s | {items}", flush=True)
            self._file.flush()
            if self._tb is not None:
                self._tb.flush()

    def log_image_grid(self, tag: str, samples: np.ndarray, step: int):
        """Tiles (N, H, W, C) samples in [0, 1] into one TensorBoard image,
        ceil(sqrt(N)) to a row as `save_image_grid` tiles them."""
        if self._tb is None:
            return
        n, h, w, c = samples.shape
        cols = int(math.ceil(math.sqrt(n)))
        rows = int(math.ceil(n / cols))
        grid = np.zeros((rows * h, cols * w, c), dtype=np.float32)
        for i in range(n):
            r, col = divmod(i, cols)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = samples[i]
        self._tb.add_image(tag, grid, step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def is_text_conditional(model) -> bool:
    """True when the model's guidance or conditioning signals, or its
    context preprocessors, carry text; for a cascade, when a stage's do."""
    if "diffusion" not in model.config():
        return any(is_text_conditional(m) for m in model.models())
    diff = model.config().diffusion
    signals = []
    if "classifier_free_guidance" in diff:
        signals += list(diff.classifier_free_guidance.get("signals", []))
    sn = diff.score_network.params if "score_network" in diff else {}
    if "conditioning" in sn:
        signals += list(sn.conditioning.signals)
    for prep in diff.get("context_preprocessing", []) or []:
        target = (prep.get("target", "") or "").lower()
        if "text" in target or "clip" in target:
            return True
    return any("text" in s for s in signals)
