"""TrainState and the training step, on one device.

Counterpart of xdiffusion_tpu/parallel/train_step.py: one step is the value
and gradient of `loss_on_batch`, the global-norm clip and the optimizer
update (optim.py), then the EMA e * decay + p * (1 - decay)
(xdiffusion_tpu/layers/ema.py). PyTorch runs it eagerly and updates the
parameters, the optimizer state and the EMA copy in place.

Under LoRA (`param_transform`, a `lora.LoRA` attached to the score
network) the optimized parameters, the EMA and the checkpoint's parameters
are the LoRA factors; the network's own parameters stay frozen. With an
`ImportanceSampler`, its loss-history state lives in the train state on the
device: the step draws the batch's timesteps and weights from it and feeds
the batch's losses back.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.optim import GradientTransform

DEFAULT_EMA_DECAY = 0.9999
_BATCH_ONLY = ("images", "timesteps", "loss_weights")


@dataclass
class TrainState:
    """step: steps taken (mini-steps under gradient accumulation); model:
    the diffusion process, whose score network holds the parameters;
    optimizer: clip + optimizer (optim.py, or its MultiSteps); ema: a copy
    of the optimized module that tracks its average, or None; generator: the
    device generator of the timesteps, noise and dropout masks; lora: the
    LoRA factors attached to the score network, which are then the
    optimized parameters, or None; importance_state: an ImportanceSampler's
    device state, or None."""

    step: int
    model: object
    optimizer: GradientTransform
    ema: Optional[nn.Module]
    generator: torch.Generator
    lora: Optional[nn.Module] = None
    importance_state: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> nn.Module:
        """The module whose parameters are optimized: the LoRA or the score network."""
        return self.lora if self.lora is not None else self.model.score_network()


def create_train_state(model, optimizer: GradientTransform, ema: bool = False,
                       seed: int = 0, importance_sampler=None, lora=None) -> TrainState:
    """`lora`: a `lora.LoRA` attached to the model's score network (its
    factors are what `optimizer` holds); `importance_sampler`: one with a
    device state (`init_device_state`), which the state then carries."""
    trainable = lora if lora is not None else model.score_network()
    ema_net = copy.deepcopy(trainable).requires_grad_(False).eval() if ema else None
    importance_state = None
    if importance_sampler is not None and hasattr(importance_sampler, "init_device_state"):
        importance_state = importance_sampler.init_device_state(model.device)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema_net,
                      generator=generator, lora=lora, importance_state=importance_state)


@torch.no_grad()
def update_ema(target: nn.Module, source: nn.Module, rate: float = 0.99) -> None:
    """target <- rate * target + (1 - rate) * source, parameter by parameter."""
    tp = list(target.parameters())
    sp = [p.detach() for p in source.parameters()]
    torch._foreach_mul_(tp, rate)
    torch._foreach_add_(tp, torch._foreach_mul(sp, 1.0 - rate))


def make_train_step(model, mesh=None, ema_decay: Optional[float] = None,
                    param_transform=None, importance_sampler=None,
                    state_shardings=None) -> Callable[[TrainState, Dict], Dict]:
    """Builds `step(state, batch) -> metrics`.

    batch: dict with 'images' in [0, 1] on the model's device, (B, H, W, C)
    or, for a video model, (B, F, H, W, C); every other key but 'timesteps' /
    'loss_weights' is conditioning context ('video_mask', 'frame_indices',
    'text_embeddings', ...). metrics hold loss, mse_loss, vb_loss,
    grad_norm (the global norm of the unclipped gradients), timesteps,
    loss_per_example and, for a mixture-of-experts network, moe_aux_loss, as
    device tensors.

    `param_transform`: the `lora.LoRA` attached to the score network, the
    state's `lora` (the JAX package's transform from the optimized LoRA tree
    to the effective parameters is the attachment itself here).
    `importance_sampler`: the process's `ImportanceSampler`; when the batch
    has no 'timesteps', each step draws them and their weights from the
    state's `importance_state` and then updates it with the batch's losses."""
    if mesh is not None or state_shardings is not None:
        raise NotImplementedError("meshes and sharded training are not ported yet")
    decay = ema_decay if ema_decay is not None else DEFAULT_EMA_DECAY

    def step(state: TrainState, batch: Dict) -> Dict:
        if state.lora is not param_transform:
            raise ValueError("make_train_step: param_transform is not the state's LoRA")
        context = {k: v for k, v in batch.items() if k not in _BATCH_ONLY}
        timesteps, loss_weights = batch.get("timesteps"), batch.get("loss_weights")
        importance = importance_sampler is not None and state.importance_state is not None
        if timesteps is None and importance:
            timesteps, loss_weights = importance_sampler.device_sample(
                state.generator, batch["images"].shape[0], state.importance_state)
        state.optimizer.zero_grad()
        loss, metrics = model.loss_on_batch(
            batch["images"], context, timesteps=timesteps, loss_weights=loss_weights,
            generator=state.generator)
        loss.backward()
        grad_norm = state.optimizer.step()
        if state.ema is not None:
            update_ema(state.ema, state.params, decay)
        if importance:
            state.importance_state = importance_sampler.device_update(
                state.importance_state, metrics["timesteps"], metrics["loss_per_example"])
        state.step += 1
        out = {
            "loss": metrics["loss"].detach(),
            "mse_loss": metrics["mse_loss"].detach(),
            "vb_loss": metrics["vb_loss"].detach(),
            "grad_norm": grad_norm,
            "timesteps": metrics["timesteps"],
            "loss_per_example": metrics["loss_per_example"],
        }
        if "moe_aux_loss" in metrics:
            out["moe_aux_loss"] = metrics["moe_aux_loss"].detach()
        return out

    return step
