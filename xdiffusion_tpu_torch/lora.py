"""LoRA fine-tuning: low-rank factors beside the kernels they adapt.

Counterpart of xdiffusion_tpu/lora.py. There LoRA is a parallel tree of
(down, up) factor pairs keyed by the flax paths of the kernels they adapt,
and the effective parameters kernel + scale * reshape(down @ up) are rebuilt
inside the traced loss. Here the factors are the parameters of a `LoRA`
module, in flax's layout (down (prod(kernel.shape[:-1]), r), up (r, out)),
and `attach` installs each delta on its network parameter as a
`torch.nn.utils.parametrize` parametrization: every read of the parameter
(each forward) returns base + scale * delta, with the delta reshaped to the
flax kernel and laid out as the port holds it (weights.py KERNEL_AXES: a
Dense's transpose, a conv's OIHW; K4's HWIO `kernel` as it is), so the
gradient reaches the factors through the kernels' autograd Functions and the
frozen base never enters the optimizer.

The adapted set is JAX's: every parameter whose flax path (weights.py
`flax_paths`) ends in `kernel`, has two or more axes and, without its leaf,
matches one of the target patterns. Norm scales (`scale`) and embedding
tables (`embedding`) are never adapted.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from xdiffusion_tpu_torch.weights import KERNEL_AXES, flax_paths, lora_from_tree, tuple_path

# Path-component regexes marking kernels to adapt, as in the JAX package.
DEFAULT_TARGET_PATTERNS = (
    r"qkv",
    r"encoder_kv",
    r"proj_out",
    r"proj",
    r"attn",
    r"mlp_fc\d",
    r"conv\d",
    r"emb_proj",
)


def adapted_names(module: nn.Module) -> List[str]:
    """The names of `module`'s parameters that LoRA adapts, in parameter order."""
    params = dict(module.named_parameters())
    out = []
    for name, path in flax_paths(module).items():
        owner, _, leaf = path.rpartition("/")
        if leaf == "kernel" and params[name].ndim >= 2 and any(
                re.search(p, owner) for p in DEFAULT_TARGET_PATTERNS):
            out.append(name)
    return out


def flax_shape(module: nn.Module, name: str) -> tuple:
    """The flax kernel shape of the port parameter `name` of `module`."""
    p = module.get_parameter(name)
    if name.rpartition(".")[2] == "kernel":  # kept in flax's layout
        return tuple(p.shape)
    inverse = np.argsort(KERNEL_AXES[p.ndim])
    return tuple(p.shape[i] for i in inverse)


class LoRA(nn.Module):
    """The trainable factors of one network: for each adapted parameter
    `names[i]`, `down[i]` (in, rank) and `up[i]` (rank, out) in flax's
    layout, in fp32 whatever the network computes in. `delta(i)` is
    reshape(down @ up) in the port's layout of that parameter."""

    def __init__(self, module: nn.Module, names: Sequence[str], rank: int = 4,
                 scale: float = 1.0):
        super().__init__()
        self.rank, self.scale = int(rank), float(scale)
        self.names = [n for n in dict(module.named_parameters()) if n in set(names)]
        paths = flax_paths(module)
        self.paths = [tuple_path(paths[n]) for n in self.names]
        self.shapes = [flax_shape(module, n) for n in self.names]
        self.axes = [None if n.rpartition(".")[2] == "kernel" else KERNEL_AXES[len(s)]
                     for n, s in zip(self.names, self.shapes)]
        device = next(module.parameters()).device
        self.down = nn.ParameterList(
            torch.zeros(int(np.prod(s[:-1])), self.rank, device=device) for s in self.shapes)
        self.up = nn.ParameterList(
            torch.zeros(self.rank, s[-1], device=device) for s in self.shapes)

    def delta(self, i: int) -> torch.Tensor:
        d = (self.down[i] @ self.up[i]).reshape(self.shapes[i])
        return d if self.axes[i] is None else d.permute(self.axes[i]).contiguous()

    def to_tree(self) -> Dict:
        """JAX's LoRA tree of these factors: {"rank", "scale", "weights":
        {flax path tuple: {"down", "up"}}} of host numpy arrays."""
        return {"rank": self.rank, "scale": self.scale, "weights": {
            path: {"down": d.detach().cpu().numpy(), "up": u.detach().cpu().numpy()}
            for path, d, u in zip(self.paths, self.down, self.up)}}


class _Delta(nn.Module):
    """The parametrization base -> base + scale * delta(i) of one parameter.
    The LoRA module is held in a list so that its factors stay its own
    parameters, not the network's."""

    def __init__(self, lora: LoRA, index: int):
        super().__init__()
        self._lora = [lora]
        self.index = index

    def forward(self, base: torch.Tensor) -> torch.Tensor:
        lora = self._lora[0]
        return base + lora.scale * lora.delta(self.index).to(base.dtype)


def inject_trainable_lora(module: nn.Module, generator: Optional[torch.Generator] = None,
                          r: int = 4) -> LoRA:
    """The LoRA of every adapted parameter of `module` at scale 1: down ~
    N(0, 1) / r (drawn from `generator`, on the module's device, in
    parameter order), up = 0, so the adapted network starts at the base."""
    lora = LoRA(module, adapted_names(module), rank=r)
    with torch.no_grad():
        for down in lora.down:
            down.copy_(torch.randn(down.shape, generator=generator, device=down.device) / r)
    return lora


def attach(module: nn.Module, lora: LoRA) -> None:
    """Freezes every parameter of `module` and installs the LoRA deltas on
    the adapted ones (base + scale * delta at every read)."""
    module.requires_grad_(False)
    for i, name in enumerate(lora.names):
        owner, _, leaf = name.rpartition(".")
        parametrize.register_parametrization(module.get_submodule(owner), leaf, _Delta(lora, i))


def detach(module: nn.Module) -> None:
    """Removes the installed deltas; the parameters are the frozen bases again."""
    for sub in list(module.modules()):
        if parametrize.is_parametrized(sub):
            for leaf in list(sub.parametrizations):
                parametrize.remove_parametrizations(sub, leaf, leave_parametrized=False)


@torch.no_grad()
def merge_lora(module: nn.Module, lora: LoRA) -> None:
    """Folds the LoRA into `module`'s parameters in place (the JAX
    package's `merge_lora`): each adapted parameter becomes base + scale *
    delta, the value `attach` gives it at every read."""
    for i, name in enumerate(lora.names):
        p = module.get_parameter(name)
        p.copy_(p + lora.scale * lora.delta(i).to(p.dtype))


def lora_param_count(lora: LoRA) -> int:
    return sum(p.numel() for p in lora.parameters())


def save_lora_weights(lora: LoRA, path: str) -> None:
    """Pickles the LoRA as the JAX package's `save_lora_weights` does (its
    tree of numpy factors), so that either package's sampling CLI reads it."""
    with open(path, "wb") as f:
        pickle.dump(lora.to_tree(), f)


def load_lora_weights(path: str, module: nn.Module) -> LoRA:
    """The LoRA of `module` in a file of `save_lora_weights`, the port's or
    the JAX package's."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    return lora_from_tree(tree, module)
