"""Training checkpoints: save, find the latest, restore.

Counterpart of xdiffusion_tpu/checkpoints.py (orbax there). A checkpoint is
one `torch.save` file, `<directory>/<step>.pt`, holding the step, the score
network's parameters, the optimizer state, the EMA parameters (or None) and
the state of the training generator, so a resumed run draws the same
timesteps, noise and dropout masks as an uninterrupted one. At most
`max_to_keep` checkpoints are kept. The orbax format is not read.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from xdiffusion_tpu_torch.train_step import TrainState


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[:-3]) for name in os.listdir(directory)
                  if name.endswith(".pt") and name[:-3].isdigit())


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{step}.pt")


def save_checkpoint(directory: str, state: TrainState, step: int,
                    max_to_keep: int = 3) -> str:
    """Writes the state at `step` (atomically) and drops the oldest
    checkpoints beyond `max_to_keep`; returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "params": state.model.score_network().state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": None if state.ema is None else state.ema.state_dict(),
        "generator": state.generator.get_state(),
    }
    path = _path(directory, step)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return path


def _resolve_dir(directory: str) -> str:
    """Accepts the checkpoint directory itself or a training run directory
    that contains a `checkpoints/` subdirectory (the layout `train` writes:
    output/<dataset>/<config>/checkpoints/<step>.pt)."""
    sub = os.path.join(directory, "checkpoints")
    if not _steps(directory) and os.path.isdir(sub):
        return sub
    return directory


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(_resolve_dir(directory))
    return steps[-1] if steps else None


def _file(path: str, step: Optional[int] = None) -> str:
    """The checkpoint file `path` names: itself, or the one at `step` (by
    default the latest) in a checkpoint or run directory."""
    if os.path.isfile(path):
        return path
    directory = _resolve_dir(path)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return _path(directory, step)


def load_params(path: str, module: torch.nn.Module, step: Optional[int] = None) -> int:
    """Loads only the parameters of a checkpoint into `module`; returns its step."""
    device = next(module.parameters()).device
    payload = torch.load(_file(path, step), map_location=device, weights_only=True)
    module.load_state_dict(payload["params"])
    return int(payload["step"])


def restore_checkpoint(path: str, state: TrainState, step: Optional[int] = None
                       ) -> Tuple[TrainState, int]:
    """Loads a checkpoint into `state` in place; returns (state, step).

    `path` is a checkpoint file, or a directory (or run directory) whose
    checkpoint at `step`, by default the latest, is read."""
    file = _file(path, step)
    device = state.model.device
    payload = torch.load(file, map_location=device, weights_only=True)
    state.model.score_network().load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if payload["ema"] is not None:
        if state.ema is None:
            raise ValueError(f"{file} holds EMA parameters; the state tracks none")
        state.ema.load_state_dict(payload["ema"])
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    return state, state.step
