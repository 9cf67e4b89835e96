"""Optimizer factories for the config `optimizer:` and
`learning_rate_schedule:` blocks.

Counterpart of xdiffusion_tpu/optim.py, which builds optax chains; here the
same chain, clip_by_global_norm -> Adam/AdamW(schedule), is a `torch.optim`
optimizer behind `GradientTransform`:

- the clip is optax's `clip_by_global_norm`: the gradients are left alone
  while their global norm is below `max_norm`, else scaled by
  max_norm / norm (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6
  and scales at any norm, so it is not used);
- `torch.optim.Adam` and `AdamW` compute optax's `adam` and `adamw` updates
  (eps outside the square root, bias corrections, decoupled weight decay);
- schedules are evaluated per update, from update 0, as optax's are;
- `MultiSteps` is `optax.MultiSteps(tx, k)`, gradient accumulation.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

# Reference training defaults (reference ddpm.py:816-842): Adam lr=2e-4,
# betas=(0.9, 0.99), global-norm grad clip 1.0.
DEFAULT_LR = 2e-4
DEFAULT_BETAS = (0.9, 0.99)
DEFAULT_GRAD_CLIP = 1.0

ScheduleFn = Callable[[int], float]


class Schedule:
    """A learning-rate schedule factory: base_lr -> (update count -> lr)."""

    def __call__(self, base_lr: float) -> ScheduleFn:
        raise NotImplementedError


class ConstantLR(Schedule):
    """torch ConstantLR semantics: lr * factor for total_iters, then lr."""

    def __init__(self, factor: float = 1.0, total_iters: int = 0, **kwargs):
        self.factor = float(factor)
        self.total_iters = int(total_iters)

    def __call__(self, base_lr: float) -> ScheduleFn:
        if self.total_iters == 0 or self.factor == 1.0:
            return lambda count: base_lr
        return lambda count: base_lr * self.factor if count < self.total_iters else base_lr


class LinearLR(Schedule):
    """torch LinearLR semantics: linear ramp start_factor -> end_factor over
    total_iters updates (optax.linear_schedule)."""

    def __init__(self, start_factor: float = 1.0 / 3.0, end_factor: float = 1.0,
                 total_iters: int = 5, **kwargs):
        self.start_factor = float(start_factor)
        self.end_factor = float(end_factor)
        self.total_iters = int(total_iters)

    def __call__(self, base_lr: float) -> ScheduleFn:
        init, end = base_lr * self.start_factor, base_lr * self.end_factor
        if self.total_iters <= 0:
            return lambda count: init

        def fn(count: int) -> float:
            frac = min(max(count, 0), self.total_iters) / self.total_iters
            return init + (end - init) * frac

        return fn


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    the norm of the per-tensor fp32 norms."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class GradientTransform:
    """clip_by_global_norm, then a torch optimizer at the scheduled rate.

    `step()` reads the parameters' `.grad`, returns their global norm before
    the clip, and updates the parameters in place."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr_fn: ScheduleFn,
                 grad_clip: Optional[float]):
        self.optimizer = optimizer
        self.lr_fn = lr_fn
        self.grad_clip = grad_clip
        self.count = 0

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self._params() if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip is not None:
            # optax: g while norm < max_norm, else g / norm * max_norm (here
            # g * (max_norm / norm)), decided on the device with no host read.
            max_norm = float(self.grad_clip)
            factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.lr_fn(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


class MultiSteps:
    """Gradient accumulation over `every_k` mini-steps, as
    `optax.MultiSteps(inner, every_k)`: each `step()` folds the mini-batch's
    gradients into their running mean (acc + (g - acc) / (n + 1), optax's),
    and every k-th runs the inner clip and optimizer on that mean, after
    which the accumulator restarts at zero; the other mini-steps leave the
    parameters as they are. The inner schedule counts real updates.
    `step()` returns the mini-batch's global norm, as the JAX train step
    reports it. The accumulator and mini-step count are in `state_dict()`."""

    def __init__(self, inner: GradientTransform, every_k: int):
        if every_k < 1:
            raise ValueError(f"MultiSteps: every_k {every_k} < 1")
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in inner._params()]

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    @property
    def count(self) -> int:
        """Real updates taken (optax's gradient_step)."""
        return self.inner.count

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = self.inner._params()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = global_norm(grads)
        n = self.mini_step
        for acc, g in zip(self.acc, grads):
            acc.add_((g - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return norm
        for p, acc in zip(params, self.acc):
            p.grad = acc.clone()
        self.inner.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0
        return norm

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)


class Optimizer:
    """Holds optimizer hyperparameters; `.build(params, schedule)` yields the
    `GradientTransform`."""

    def __init__(self, lr: float = DEFAULT_LR, betas: Sequence[float] = DEFAULT_BETAS,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = DEFAULT_GRAD_CLIP, **kwargs):
        self.lr = float(lr)
        self.betas = tuple(betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.grad_clip = grad_clip

    def _core(self, params, lr: float) -> torch.optim.Optimizer:
        raise NotImplementedError

    def build(self, params: Iterable[torch.Tensor],
              schedule: Optional[Schedule] = None) -> GradientTransform:
        lr_fn = schedule(self.lr) if schedule is not None else (lambda count: self.lr)
        return GradientTransform(self._core(list(params), lr_fn(0)), lr_fn, self.grad_clip)


class Adam(Optimizer):
    def _core(self, params, lr):
        return torch.optim.Adam(params, lr=lr, betas=self.betas, eps=self.eps)


class AdamW(Optimizer):
    def __init__(self, weight_decay: float = 1e-2, **kwargs):
        kwargs.pop("weight_decay", None)
        super().__init__(weight_decay=weight_decay, **kwargs)

    def _core(self, params, lr):
        return torch.optim.AdamW(params, lr=lr, betas=self.betas, eps=self.eps,
                                 weight_decay=self.weight_decay)


def default_optimizer() -> Adam:
    return Adam()
