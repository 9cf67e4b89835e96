"""Weight bridge from the JAX package's flax parameters to the port.

A flax parameter tree arrives flattened: a dict of numpy arrays keyed by
`/`-joined paths (`flax.traverse_util.flatten_dict(params["params"])`
joined with "/", or the keys of a `.npz` written that way). The port's
module names mirror those paths, so each leaf maps mechanically:

- `.../kernel` of a Dense (I, O) -> `....weight` (O, I) of `layers.linear.Dense`;
- `.../kernel` of a Conv (H, W, I, O) -> `....weight` (O, I, H, W) of
  `layers.linear.ConvNHWC`, for the convolutions that run as `F.conv2d`
  (a depthwise conv's (H, W, 1, C), Sana's `mix_ffn/conv_depth`, becomes
  the grouped (C, 1, H, W));
- `.../kernel` of a 3-D Conv (D, H, W, I, O) (the video VAEs) -> `....weight`
  (O, I, D, H, W) of `layers.linear.Conv`, as does a 2-D one of the image
  VAE, its discriminator and the perceptual pyramid;
- `.../kernel` of a 1-D Conv (K, I, O) (Video-LDM's temporal
  `block<i>_conv`, WideFormer's `token_mixer` with the tokens as channels)
  -> `....weight` (O, I, K) of an `nn.Conv1d`;
- `.../kernel` of a residual block's conv1/conv2 stays HWIO under
  `....kernel` (`layers.resnet.FusedAffineConv`): K4 reads that layout;
- `.../embedding` of an `nn.Embed` (N, D) -> `....weight` (N, D) of
  `nn.Embedding` (the class-conditional networks' `_label_projection/embed`
  with its NULL row, the text towers' `token_embedding`, `shared` and T5's
  block-0 `relative_attention_bias`);
- `scale` and `bias` keep their names and shapes (LayerNorms too, and the
  gain-only `context_norm` has no bias), and so does any other leaf (the
  LTX transformer's `scale_shift_table`s, the stacked expert parameters
  `experts_fc1` (E, D, H), `experts_fc2` (E, H, D) and their biases of
  `layers.moe.MoEMlp`, the GLIDE head's `positional_embedding` (1, 1, W),
  the pooled-text head's `pool_query` (D,), PixArt's `scale_shift_table`
  (6, D) and `final_scale_shift_table` (2, D), DyT's scalar `alpha`,
  `gamma` and `beta`, the video UNets' gates `alpha` (1,) and per-head
  relative-position tables `rel_k_embeddings`/`rel_v_embeddings`, AuraFlow's learned `pos_embed` (1, P, D) and
  `register_tokens` (1, 8, D), S4D's `C` (H, N/2, 2), `log_dt` (H,),
  `log_A_real` and `A_imag` (H, N/2) and `D` (H,), Sora's per-block
  `scale_shift_table` (6, D) and `final_scale_shift_table` (2, D),
  `KVCompressAttention`'s depthwise `sr_kernel` (s, s, 1, C), HWIO as flax
  holds it, and `sr_bias`, the CLIP text tower's `position_embedding`
  (P, D), the T5 RMS norms' `scale`). A learned-sigma network's doubled output head is
  an ordinary conv or Dense of twice the channels. HunyuanVideo's token
  refiner keeps its flax names (`txt_refiner/adaLN_<i>`, `norm1_<i>`, ...).

Context heads with parameters sit at `_context_heads_<i>` and the token
tables at `_projections_text_tokens/embed`, as in the flax tree. The UNets'
stage lists of (kind, module) pairs, Flexible Diffusion Modeling's too, give
flax names such as `_downs_3_1_1/temporal_attention/rpe_k/out` (stage 3,
element 1, the module of its pair): the port registers each module under
the same name (score_networks/unet.py `register_stages`).

A module with a `flax_param_prefix` holds the flax tree under that prefix:
the EDM preconditioners (score_networks/edm.py) own their backbone as
`model`, whose flax parameters are the tree of the JAX backbone. The
NCSN++ Fourier embedding's `map_noise/freqs` lands in its buffer. The
consistency process's params dict of three such trees maps tree by tree,
each onto the network of its name (the process's `networks()`). A
cascade's params {"stage_<k>": {"params": tree}} flatten as
`stage_<k>/<path>` onto its `score_network()`, the `nn.ModuleDict` of the
stages' networks (diffusion/cascade.py). An autoencoder's params
{"ae": {"params": tree}, "disc": {"params": tree}} (the JAX VAE-GAN
trainers' two optimizer groups; "disc" is the loss module's: the
discriminator and the learned `logvar`, a scalar) flatten as `ae/<path>` and
`disc/<path>` onto the autoencoder's `ae` and `disc` submodules
(autoencoders/base.py).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


# A flax kernel of each rank -> the port's `weight` layout: Dense (I, O) ->
# (O, I); Conv1d (K, I, O) -> (O, I, K); Conv (H, W, I, O) -> OIHW; 3-D Conv
# (D, H, W, I, O) -> (O, I, D, H, W).
KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def flax_paths(module: nn.Module) -> Dict[str, str]:
    """The `/`-joined flax path of each parameter of `module` (the inverse
    of `flax_to_state_dict`'s names): `flax_param_prefix` dropped, a
    `weight` leaf becomes `embedding` in an `nn.Embedding` and `kernel`
    elsewhere, other leaves (an HWIO `kernel`, `scale`, `bias`, ...) keep
    their names. The layout of a `kernel` whose port leaf is `weight` is
    KERNEL_AXES[ndim] of flax's."""
    base = getattr(module, "flax_param_prefix", "")
    out = {}
    for name, _ in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        if leaf == "weight":
            owner = module.get_submodule(owner_name)
            leaf = "embedding" if isinstance(owner, nn.Embedding) else "kernel"
        path = (owner_name + "." + leaf if owner_name else leaf)
        if base and path.startswith(base):
            path = path[len(base):]
        out[name] = path.replace(".", "/")
    return out


def flax_to_state_dict(flat: Mapping[str, np.ndarray], module: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """The port `state_dict` of `module` that holds the flax leaves `flat`.

    Raises if a leaf has no place in the module, a shape differs, or a
    parameter of the module is left without a leaf."""
    target = module.state_dict()
    base = getattr(module, "flax_param_prefix", "")
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        prefix, _, leaf = path.rpartition("/")
        prefix = base + (prefix.replace("/", ".") + "." if prefix else "")
        key = prefix + leaf
        if leaf == "kernel" and key not in target:
            key = prefix + "weight"
            if arr.ndim in KERNEL_AXES:
                arr = arr.transpose(KERNEL_AXES[arr.ndim])
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


def state_dict_to_flax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The flattened flax leaves (float32 numpy, flax's layout) of the
    parameters of `module`: the inverse of `flax_to_state_dict`."""
    params = dict(module.named_parameters())
    out = {}
    for name, path in flax_paths(module).items():
        arr = params[name].detach().float().cpu().numpy()
        if (name.rpartition(".")[2] == "weight" and path.endswith("kernel")
                and arr.ndim in KERNEL_AXES):
            arr = arr.transpose(np.argsort(KERNEL_AXES[arr.ndim]))
        out[path] = np.array(arr, order="C")  # a copy, not a view of the parameter
    return out


def load_flax_params(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Loads flattened flax parameters into `module` in place."""
    module.load_state_dict(flax_to_state_dict(flat, module))


def lora_from_tree(tree: Mapping, module: nn.Module):
    """The port's `lora.LoRA` of a JAX LoRA tree for `module`: {"rank": r,
    "scale": s, "weights": {flax path tuple: {"down": (in, r), "up": (r,
    out)}}} as `xdiffusion_tpu.lora.inject_trainable_lora` builds it and
    `save_lora_weights` pickles it (numpy factors; a tuple path holds the
    tree's "params" collection and ends in "kernel"). The factors keep
    flax's layout. Raises if a path names no parameter of `module` or a
    factor's shape does not fit its kernel."""
    from xdiffusion_tpu_torch.lora import LoRA

    by_path = {tuple_path(path): name for name, path in flax_paths(module).items()}
    params = dict(module.named_parameters())
    names, down, up = [], [], []
    for key, factors in tree["weights"].items():
        if tuple(key) not in by_path:
            raise KeyError(f"LoRA path {key!r} names no parameter of the port's network")
        names.append(by_path[tuple(key)])
        down.append(torch.from_numpy(np.array(factors["down"], dtype=np.float32)))
        up.append(torch.from_numpy(np.array(factors["up"], dtype=np.float32)))
    lora = LoRA(module, names, rank=int(tree["rank"]), scale=float(tree["scale"]))
    with torch.no_grad():
        for i, name in enumerate(lora.names):
            j = names.index(name)
            if down[j].shape != lora.down[i].shape or up[j].shape != lora.up[i].shape:
                raise ValueError(f"LoRA factors {tuple(down[j].shape)} x {tuple(up[j].shape)} "
                                 f"do not fit {name} {tuple(params[name].shape)}")
            lora.down[i].copy_(down[j])
            lora.up[i].copy_(up[j])
    return lora


def tuple_path(path: str) -> tuple:
    """A `/`-joined flax path as the key of the JAX package's parameter
    tree: ("params", ...) or, for a cascade stage's parameter, ("stage_<k>",
    "params", ...)."""
    parts = tuple(path.split("/"))
    if parts[0].startswith("stage_"):
        return parts[:1] + ("params",) + parts[1:]
    return ("params",) + parts


def load_checkpoint(module: nn.Module, path: str) -> int:
    """Loads a port `state_dict` (`.pt`), a training checkpoint (`.pt` of
    checkpoints.py or of the distill_consistency CLI, or the latest in a
    checkpoint or run directory: its EMA parameters when it tracks them,
    else its parameters, as the JAX package's sampling CLI and consistency
    `sample` take them) or flattened flax params (`.npz`). Returns the
    training step a checkpoint records, 0 for a bare state dict or flax
    params, which carry none."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            load_flax_params(module, {k: data[k] for k in data.files})
        return 0
    if os.path.isdir(path):  # a checkpoint or run directory: its latest
        from xdiffusion_tpu_torch.checkpoints import _file

        path = _file(path)
    # Memory-mapped: of a training checkpoint only the tensors loaded here
    # are read, not the optimizer state beside them.
    payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    step = 0
    if "params" in payload and "step" in payload:
        step = int(payload["step"])
        payload = payload["ema"] if payload.get("ema") is not None else payload["params"]
    module.load_state_dict(payload)
    return step


_EXPERT_KERNELS = ("experts_fc1", "experts_fc2")


def draw(name: str, shape, fan_in: int, rng: np.random.Generator) -> np.ndarray:
    """A seeded stand-in for a trained parameter: kernels N(0, 1/fan_in),
    norm scales (DyT's `gamma` too) 1 + N(0, 0.1^2), biases (expert biases
    and DyT's `beta` too) N(0, 0.1^2), DyT's `alpha` 0.5 + N(0, 0.1^2),
    adaLN scale-shift tables N(0, 1/width) as flax initialises them, S4D's
    `log_dt` uniform in [log 1e-3, log 1e-1], `log_A_real` log 0.5 + N(0,
    0.1^2) and `A_imag` pi n + N(0, 0.1^2) around its S4D-Lin values (its
    `C` and `D`, like AuraFlow's `pos_embed` and `register_tokens`, N(0, 1)).
    Every parameter is drawn, so zero-initialised convs and projections take
    part."""
    if name in ("scale", "gamma"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("bias", "beta") or name.endswith("_bias"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "alpha":  # DyT's scalar gain, initially 0.5
        return np.asarray(0.5 + 0.1 * rng.standard_normal(shape), dtype=np.float32)
    if name == "log_dt":
        return rng.uniform(np.log(1e-3), np.log(1e-1), size=shape).astype(np.float32)
    if name == "log_A_real":
        return (np.log(0.5) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "A_imag":
        return (np.pi * np.arange(shape[-1]) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name.endswith("scale_shift_table"):
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
            p.copy_(torch.from_numpy(np.asarray(draw(leaf, tuple(p.shape), fan_in, rng),
                                                dtype=np.float32)))
