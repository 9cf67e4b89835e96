"""Training checkpoints: save, find the latest, restore.

Counterpart of xdiffusion_tpu/checkpoints.py (orbax there). A checkpoint is
one `torch.save` file, `<directory>/<step>.pt`, holding the step, the
optimized parameters (the score network's, or under LoRA the factors), the
optimizer state (with a gradient accumulator's mean and mini-step), the EMA
parameters (or None), an importance sampler's loss-history state (or None)
and the state of the training generator, so a resumed run draws the same
timesteps, noise and dropout masks as an uninterrupted one. An autoencoder's
checkpoint (training/image/autoencoder.py) holds its parameters (`ae.*` and
`disc.*`), both optimizers and the generator, through `write_payload` and
`read_payload`. At most
`max_to_keep` checkpoints are kept. The orbax format is not read.

`restore_params_partial` is the image-to-video warm start: every parameter
of a checkpoint whose name and shape match one of the module's fills it,
the others stay at their initial values, and each of those must be a
temporal module's (its name holds one of `TEMPORAL_KEY_MARKERS`), as the
JAX package asserts.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

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
    return write_payload(directory, step, {
        "params": state.params.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": None if state.ema is None else state.ema.state_dict(),
        "importance": state.importance_state,
        "generator": state.generator.get_state(),
    }, max_to_keep)


def write_payload(directory: str, step: int, payload: Dict, max_to_keep: int = 3) -> str:
    """Writes `payload` and the step as <directory>/<step>.pt (atomically),
    drops the oldest checkpoints beyond `max_to_keep`; returns the path."""
    os.makedirs(directory, exist_ok=True)
    payload = dict(payload, step=int(step))
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


def read_payload(path: str, device, step: Optional[int] = None) -> Dict:
    """The payload of the checkpoint `path` names (a file, or a checkpoint
    or run directory's checkpoint at `step`, by default the latest)."""
    return torch.load(_file(path, step), map_location=device, weights_only=True)


def load_params(path: str, module: torch.nn.Module, step: Optional[int] = None) -> int:
    """Loads only the parameters of a checkpoint into `module` (the file
    memory-mapped: the rest of it is not read); returns its step."""
    payload = torch.load(_file(path, step), map_location="cpu", weights_only=True, mmap=True)
    module.load_state_dict(payload["params"])
    return int(payload["step"])


def restore_checkpoint(path: str, state: TrainState, step: Optional[int] = None
                       ) -> Tuple[TrainState, int]:
    """Loads a checkpoint into `state` in place; returns (state, step). The
    file's EMA parameters are read when the state tracks an EMA.

    `path` is a checkpoint file, or a directory (or run directory) whose
    checkpoint at `step`, by default the latest, is read."""
    file = _file(path, step)
    device = state.model.device
    payload = torch.load(file, map_location=device, weights_only=True)
    state.params.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["optimizer"])
    # A state that tracks no EMA leaves the file's unread (the import CLI
    # writes one for every config).
    if payload["ema"] is not None and state.ema is not None:
        state.ema.load_state_dict(payload["ema"])
    if payload.get("importance") is not None:
        if state.importance_state is None:
            raise ValueError(f"{file} holds importance-sampler state; the state has none")
        state.importance_state = dict(payload["importance"])
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    return state, state.step


# Names of the parameters that a video network may lack in an image
# network's checkpoint: its temporal extensions.
TEMPORAL_KEY_MARKERS = ("tconv", "temporal", "motion", "attn_t", "time_mix", "adapter")


@torch.no_grad()
def restore_params_partial(path: str, module: torch.nn.Module) -> Tuple[int, List[str]]:
    """Fills each parameter of `module` from the latest checkpoint's
    parameter of the same name and shape; returns (the checkpoint's step,
    the names of the parameters left at init). Raises unless every one left
    is a temporal module's."""
    payload = torch.load(_file(path), map_location="cpu", weights_only=True, mmap=True)
    old = payload["params"]
    missing = []
    for name, p in module.named_parameters():
        if name in old and tuple(old[name].shape) == tuple(p.shape):
            p.copy_(old[name].to(p.dtype))
        else:
            missing.append(name)
    unexpected = [m for m in missing
                  if not any(marker in m.lower() for marker in TEMPORAL_KEY_MARKERS)]
    if unexpected:
        raise ValueError("partial restore: missing keys are not all temporal/motion "
                         f"modules: {unexpected[:10]}")
    return int(payload["step"]), missing
