"""Weight bridge from the JAX package's flax parameters to the port.

A flax parameter tree arrives flattened: a dict of numpy arrays keyed by
`/`-joined paths (`flax.traverse_util.flatten_dict(params["params"])`
joined with "/", or the keys of a `.npz` written that way). The port's
module names mirror those paths, so each leaf maps mechanically:

- `.../kernel` of a Dense (I, O) -> `....weight` (O, I) of `layers.linear.Dense`;
- `.../kernel` of a Conv (H, W, I, O) -> `....weight` (O, I, H, W) of
  `layers.linear.ConvNHWC`, for the convolutions that run as `F.conv2d`;
- `.../kernel` of a residual block's conv1/conv2 stays HWIO under
  `....kernel` (`layers.resnet.FusedAffineConv`): K4 reads that layout;
- `.../embedding` of an `nn.Embed` (N, D) -> `....weight` (N, D) of `nn.Embedding`;
- `scale` and `bias` keep their names and shapes, and so does any other
  leaf (the LTX transformer's `scale_shift_table`s, the stacked expert
  parameters `experts_fc1` (E, D, H), `experts_fc2` (E, H, D) and their
  biases of `layers.moe.MoEMlp`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def flax_to_state_dict(flat: Mapping[str, np.ndarray], module: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """The port `state_dict` of `module` that holds the flax leaves `flat`.

    Raises if a leaf has no place in the module, a shape differs, or a
    parameter of the module is left without a leaf."""
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        prefix, _, leaf = path.rpartition("/")
        prefix = prefix.replace("/", ".") + "." if prefix else ""
        key = prefix + leaf
        if leaf == "kernel" and key not in target:
            key = prefix + "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "embedding" and key not in target:
            key = prefix + "weight"
        if key not in target:
            raise KeyError(f"flax leaf {path!r} has no parameter {key!r} in the port")
        if tuple(target[key].shape) != arr.shape:
            raise ValueError(
                f"{path!r}: shape {arr.shape} against {tuple(target[key].shape)} at {key!r}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"no flax leaf for port parameters {missing[:8]}")
    return out


def load_flax_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Loads flattened flax parameters into `module` in place."""
    module.load_state_dict(flax_to_state_dict(flat, module))


def load_checkpoint(module: nn.Module, path: str) -> int:
    """Loads a port `state_dict` (`.pt`), a training checkpoint (`.pt` of
    checkpoints.py: its EMA parameters when it tracks them, else its
    parameters, as the JAX package's sampling CLI restores one) or flattened
    flax params (`.npz`). Returns the training step a checkpoint records,
    0 for a bare state dict or flax params, which carry none."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            load_flax_params(module, {k: data[k] for k in data.files})
        return 0
    device = next(module.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    step = 0
    if "params" in payload and "step" in payload:
        step = int(payload["step"])
        payload = payload["ema"] if payload.get("ema") is not None else payload["params"]
    module.load_state_dict(payload)
    return step


_EXPERT_KERNELS = ("experts_fc1", "experts_fc2")


def draw(name: str, shape, fan_in: int, rng: np.random.Generator) -> np.ndarray:
    """A seeded stand-in for a trained parameter: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1^2), biases (expert biases too) N(0, 0.1^2),
    adaLN scale-shift tables N(0, 1/width) as flax initialises them. Every
    parameter is drawn, so zero-initialised convs and projections take
    part."""
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "bias" or name.endswith("_bias"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "scale_shift_table":
        return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(np.float32)
    return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)


def random_flax_params(flat: Mapping[str, np.ndarray], seed: int) -> Dict[str, np.ndarray]:
    """Flattened flax parameters of the shapes of `flat`, redrawn with `draw`
    in path order (Dense kernels (I, O) and Conv kernels (H, W, I, O) take
    their fan-in from the leading axes, stacked expert kernels (E, I, O)
    from I)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(flat):
        shape = tuple(np.shape(flat[path]))
        leaf = path.rpartition("/")[2]
        if leaf in _EXPERT_KERNELS:
            fan_in = shape[-2]
        else:
            fan_in = int(np.prod(shape[:-1])) if leaf == "kernel" else 1
        out[path] = draw(leaf, shape, fan_in, rng)
    return out


def randomize_(module: nn.Module, seed: int) -> None:
    """Redraws every parameter of `module` with `draw`, in name order."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            leaf = name.rpartition(".")[2]
            if leaf == "kernel":  # HWIO
                fan_in = p.shape[0] * p.shape[1] * p.shape[2]
            elif leaf in _EXPERT_KERNELS:  # (E, I, O)
                fan_in = p.shape[-2]
            elif leaf == "weight":  # (O, I) or OIHW
                fan_in = p[0].numel()
            else:
                fan_in = 1
            p.copy_(torch.from_numpy(draw(leaf, tuple(p.shape), fan_in, rng)))
