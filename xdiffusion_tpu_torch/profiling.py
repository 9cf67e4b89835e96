"""Tracing and numerical debugging of training runs.

Counterpart of xdiffusion_tpu/profiling.py:

- `StepProfiler` traces steps [start, start + num_steps) with
  `torch.profiler` (CPU and, on a card, CUDA activity: every kernel launch)
  into `<logdir>/profile/` in TensorBoard's trace layout
  (`<name>.pt.trace.json`);
- `nan_debugging` is the counterpart of `jax_debug_nans`: while active,
  the forward of every submodule of the given modules that yields a NaN, or
  the backward of one that yields a NaN gradient for its inputs, raises
  `FloatingPointError` naming that module, and autograd's anomaly mode (NaN
  check on) catches a NaN gradient of any other operation. It is a context:
  JAX leaves its flag on for the process, the port restores the previous
  state on leaving;
- `step_timer`: wall-clock timing with a device barrier.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
import torch.nn as nn


class StepProfiler:
    """Trace steps [start_step, start_step + 3) into `logdir`/profile.

        profiler = StepProfiler(out_dir, start_step=100)
        for step in ...:
            profiler.maybe_start(step)
            ... run step ...
            profiler.maybe_stop(step)
        profiler.close()
    """

    num_steps = 3

    def __init__(self, logdir: str, start_step: int = -1):
        self.logdir = os.path.join(logdir, "profile")
        self.start_step = int(start_step)
        self._profile = None

    def maybe_start(self, step: int) -> None:
        if self.start_step >= 0 and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.logdir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                activities.append(ProfilerActivity.CUDA)
            self._profile = profile(activities=activities)
            self._profile.start()

    def maybe_stop(self, step: int) -> None:
        if self._profile is not None and step >= self.start_step + self.num_steps - 1:
            self._stop()

    def close(self) -> None:
        """Writes an unfinished trace (the run ended inside the window)."""
        if self._profile is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._profile.stop()
        last = self.start_step + self.num_steps - 1
        self._profile.export_chrome_trace(os.path.join(
            self.logdir, f"steps_{self.start_step}-{last}.{time.time_ns()}.pt.trace.json"))
        self._profile = None
        print(f"profiler trace written to {self.logdir}", flush=True)


def _nan(tensors) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any())
               for t in tensors)


def _flat(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _flat(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _flat(v)]
    return []


@contextlib.contextmanager
def nan_debugging(*modules: nn.Module, enable: bool = True) -> Iterator[None]:
    """Raises `FloatingPointError` at the first NaN made in the forward or
    backward of `modules` while active (see the module docstring); a no-op
    unless `enable`."""
    if not enable:
        yield
        return
    handles = []

    def forward_hook(name, module, args, kwargs, output):
        if _nan(_flat(output)):
            raise FloatingPointError(
                f"NaN in the forward of {name or 'the network'} ({type(module).__name__})")
        for t in _flat(args) + _flat(kwargs):
            if t.requires_grad:
                t.register_hook(lambda g, name=name, kind=type(module).__name__: _check_grad(
                    g, name, kind))

    def _check_grad(g, name, kind):
        if g is not None and torch.isnan(g).any():
            raise FloatingPointError(
                f"NaN in the backward of {name or 'the network'} ({kind}): the gradient "
                "of its input")

    for root in modules:
        for name, module in root.named_modules():
            handles.append(module.register_forward_hook(
                lambda m, a, k, o, name=name: forward_hook(name, m, a, k, o), with_kwargs=True))
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    except RuntimeError as e:
        if "nan values" in str(e).lower():
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        torch.autograd.set_detect_anomaly(*anomaly)
        for handle in handles:
            handle.remove()


@contextlib.contextmanager
def step_timer(sync: bool = True) -> Iterator[dict]:
    """Wall-clock timing, with `torch.cuda.synchronize()` at exit when a
    card is in use."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
