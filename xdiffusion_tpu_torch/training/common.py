"""Shared training-loop utilities: sample grids, metric logging, and whether
a model takes text.

Counterpart of xdiffusion_tpu/training/common.py, and of
`_is_text_conditional` of xdiffusion_tpu/training/image/train.py, which the
video trainer and the video sampling CLI share. Metrics go to
<output_path>/metrics.jsonl and, every `print_every` steps, to the console;
the JAX package's TensorBoard mirror is not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch

from xdiffusion_tpu_torch.sample import save_image_grid  # noqa: F401  (re-exported)


class MetricsLogger:
    """JSONL step metrics + console progress."""

    def __init__(self, output_path: str, print_every: int = 100):
        os.makedirs(output_path, exist_ok=True)
        self._file = open(os.path.join(output_path, "metrics.jsonl"), "a")
        self._print_every = print_every
        self._t0 = time.time()
        self._last_print = self._t0
        self._last_step = 0

    def log(self, step: int, metrics: Dict[str, float]):
        """Writes one record; tensor values are read to the host (a sync)."""
        values = {k: float(v.item() if isinstance(v, torch.Tensor) else v)
                  for k, v in metrics.items()}
        record = {"step": step, "time": time.time() - self._t0, **values}
        self._file.write(json.dumps(record) + "\n")
        if step % self._print_every == 0:
            now = time.time()
            sps = (step - self._last_step) / max(now - self._last_print, 1e-9)
            self._last_print, self._last_step = now, step
            items = " ".join(f"{k}={v:.4g}" for k, v in values.items())
            print(f"step {step} | {sps:.2f} steps/s | {items}", flush=True)
            self._file.flush()

    def close(self):
        self._file.close()


def is_text_conditional(model) -> bool:
    """True when the model's guidance or conditioning signals, or its
    context preprocessors, carry text."""
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
