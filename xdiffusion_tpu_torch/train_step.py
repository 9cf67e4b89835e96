"""TrainState and the training step, on one device.

Counterpart of xdiffusion_tpu/parallel/train_step.py: one step is the value
and gradient of `loss_on_batch`, the global-norm clip and the optimizer
update (optim.py), then the EMA e * decay + p * (1 - decay)
(xdiffusion_tpu/layers/ema.py). PyTorch runs it eagerly and updates the
parameters, the optimizer state and the EMA copy in place.
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
    """step: updates taken; model: the diffusion process, whose score network
    holds the parameters; optimizer: clip + optimizer; ema: a copy of the
    score network that tracks its average, or None; generator: the device
    generator of the timesteps, noise and dropout masks."""

    step: int
    model: object
    optimizer: GradientTransform
    ema: Optional[nn.Module]
    generator: torch.Generator


def create_train_state(model, optimizer: GradientTransform, ema: bool = False,
                       seed: int = 0, importance_sampler=None) -> TrainState:
    if importance_sampler is not None and hasattr(importance_sampler, "init_device_state"):
        raise NotImplementedError("device-side importance sampling is not ported yet")
    ema_net = None
    if ema:
        ema_net = copy.deepcopy(model.score_network()).requires_grad_(False).eval()
    generator = torch.Generator(device=model.device).manual_seed(seed)
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema_net,
                      generator=generator)


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
    device tensors."""
    if mesh is not None or state_shardings is not None:
        raise NotImplementedError("meshes and sharded training are not ported yet")
    if param_transform is not None:
        raise NotImplementedError("LoRA training (param_transform) is not ported yet")
    if importance_sampler is not None:
        raise NotImplementedError("importance-sampler state is not ported yet")
    decay = ema_decay if ema_decay is not None else DEFAULT_EMA_DECAY

    def step(state: TrainState, batch: Dict) -> Dict:
        context = {k: v for k, v in batch.items() if k not in _BATCH_ONLY}
        state.optimizer.zero_grad()
        loss, metrics = model.loss_on_batch(
            batch["images"], context, timesteps=batch.get("timesteps"),
            loss_weights=batch.get("loss_weights"), generator=state.generator)
        loss.backward()
        grad_norm = state.optimizer.step()
        if state.ema is not None:
            update_ema(state.ema, model.score_network(), decay)
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
