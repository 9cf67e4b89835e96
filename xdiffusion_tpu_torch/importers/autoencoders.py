"""Torch-reference autoencoder state_dicts into the port's autoencoders.

Counterpart of xdiffusion_tpu/importers/autoencoders.py, resolved on the
port's modules as importers/torch_state_dict.py resolves a score network:
each parameter of the autoencoder's `ae` submodule (the JAX package's
params["ae"] tree; autoencoders/base.py) by its flax path, laid out as the
weight bridge lays it out.

Covers the LDM image VAE (`AutoencoderKL`, reference autoencoders/
kl.py:9-148 built from layers.py:8-371), whose module tree is:

    encoder.conv_in / encoder.down.{l}.block.{i}.{norm1,conv1,norm2,
    conv2,nin_shortcut} / encoder.down.{l}.attn.{i}.{norm,q,k,v,proj_out}
    / encoder.down.{l}.downsample.conv / encoder.mid.{block_1,attn_1,
    block_2} / encoder.{norm_out,conv_out} ; decoder symmetric with
    up.{l}.{block,attn,upsample} ; quant_conv / post_quant_conv.

The flax module (`autoencoders/kl.py`), and the port after it, names the same structure
encoder/down_{l}_block_{i}(norm1,conv1,norm2,conv2,skip),
down_{l}_attn_{i}(norm,q,k,v,proj), down_{l}_downsample, mid_block_1,
mid_attn, mid_block_2, norm_out, conv_out (decoder: up_*). Layout
conversions are the standard ones (Conv2d OIHW->HWIO; the attention's
1x1 convs -> Dense (I, O)); `loss.*` keys (discriminator + logvar) are
ignored — the GAN loss has its own parameter tree here.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

import torch.nn as nn

from xdiffusion_tpu_torch.importers.torch_state_dict import (
    Array,
    Layout,
    Transform,
    _apply_mapping,
    _conv2d,
    _conv2d_1x1_dense as _conv1x1_dense,
    _conv3d,
    _dense,
    _identity,
)


_BLOCK_RE = re.compile(r"^(down|up)_(\d+)_block_(\d+)$")
_ATTN_RE = re.compile(r"^(down|up)_(\d+)_attn_(\d+)$")
_RESAMPLE_RE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")

# flax child -> (torch suffix, weight transform); norms use _identity.
_RES_LEAVES = {
    "norm1": ("norm1", None),
    "conv1": ("conv1", _conv2d),
    "norm2": ("norm2", None),
    "conv2": ("conv2", _conv2d),
    "skip": ("nin_shortcut", _conv2d),
}
_ATTN_LEAVES = {
    "norm": ("norm", None),
    "q": ("q", _conv1x1_dense),
    "k": ("k", _conv1x1_dense),
    "v": ("v", _conv1x1_dense),
    "proj": ("proj_out", _conv1x1_dense),
}


def _leaf(base: str, flax_leaf: str) -> str:
    return base + (".weight" if flax_leaf in ("scale", "kernel") else ".bias")


def _resolve_coder(tower: str, path: Tuple[str, ...]):
    """Resolve one leaf inside encoder/decoder. `path` excludes the tower
    name, e.g. ("down_0_block_1", "conv1", "kernel")."""
    top, leaf = path[0], path[-1]

    if top in ("conv_in", "conv_out"):
        return (_leaf(f"{tower}.{top}", leaf), _conv2d if leaf == "kernel" else _identity)
    if top == "norm_out":
        return (_leaf(f"{tower}.norm_out", leaf), _identity)
    if top in ("mid_block_1", "mid_block_2"):
        n = top[len("mid_block_") :]
        child = path[1]
        suffix, tf = _RES_LEAVES[child]
        base = f"{tower}.mid.block_{n}.{suffix}"
        return (_leaf(base, leaf), tf if leaf == "kernel" else _identity)
    if top == "mid_attn":
        child = path[1]
        suffix, tf = _ATTN_LEAVES[child]
        base = f"{tower}.mid.attn_1.{suffix}"
        return (_leaf(base, leaf), tf if leaf == "kernel" else _identity)

    m = _BLOCK_RE.match(top)
    if m:
        lvl, i = m.group(2), m.group(3)
        child = path[1]
        suffix, tf = _RES_LEAVES[child]
        base = f"{tower}.{m.group(1)}.{lvl}.block.{i}.{suffix}"
        return (_leaf(base, leaf), tf if leaf == "kernel" else _identity)
    m = _ATTN_RE.match(top)
    if m:
        lvl, i = m.group(2), m.group(3)
        child = path[1]
        suffix, tf = _ATTN_LEAVES[child]
        base = f"{tower}.{m.group(1)}.{lvl}.attn.{i}.{suffix}"
        return (_leaf(base, leaf), tf if leaf == "kernel" else _identity)
    m = _RESAMPLE_RE.match(top)
    if m:
        base = f"{tower}.{m.group(1)}.{m.group(2)}.{m.group(3)}.conv"
        return (_leaf(base, leaf), _conv2d if leaf == "kernel" else _identity)
    return None


# -- LTX-Video causal VAE (reference autoencoders/ltx_vae.py:81-1425) --------

# torch (C, 1, 1) noise-injection scales -> (C,).
_per_channel = Layout(lambda w: w.reshape(-1), lambda w: w.reshape(-1, 1, 1))
# A 0-d torch parameter -> flax's ().
_scalar_param = Layout(lambda w: np.asarray(w).reshape(()), lambda w: w.reshape(()))

_LTX_TOP_RE = re.compile(r"^(down|up)_(\d+)_(.+)$")
_LTX_RES_RE = re.compile(r"^res_(\d+)$")
_LTX_ATTN_RE = re.compile(r"^attn_(\d+)$")


def _ltx_conv(base: str, rest: Tuple[str, ...]):
    """CausalConv3d (<base>.conv.*) or DualConv3d (<base>.weight1/2)."""
    leaf = rest[-1]
    if rest[0] == "conv":
        return (
            f"{base}.conv." + ("weight" if leaf == "kernel" else "bias"),
            _conv3d if leaf == "kernel" else _identity,
        )
    if rest[0] == "conv_spatial":
        return (
            f"{base}." + ("weight1" if leaf == "kernel" else "bias1"),
            _conv3d if leaf == "kernel" else _identity,
        )
    if rest[0] == "conv_temporal":
        return (
            f"{base}." + ("weight2" if leaf == "kernel" else "bias2"),
            _conv3d if leaf == "kernel" else _identity,
        )
    return None


def _ltx_norm(base: str, rest: Tuple[str, ...]):
    """_Norm: GroupNorm maps to <base>.weight, the reference's LayerNorm
    wrapper to <base>.norm.weight (ltx_vae.py:1016-1024)."""
    leaf = rest[-1]
    if rest[0] == "gn":
        return (_leaf(base, leaf), _identity)
    if rest[0] == "ln":
        return (_leaf(f"{base}.norm", leaf), _identity)
    return None


def _ltx_resnet(base: str, rest: Tuple[str, ...]):
    child, leaf = rest[0], rest[-1]
    if child in ("norm1", "norm2"):
        return _ltx_norm(f"{base}.{child}", rest[1:])
    if child in ("conv1", "conv2"):
        return _ltx_conv(f"{base}.{child}", rest[1:])
    if child == "norm3":
        # Shortcut-path LayerNorm wrapper (ltx_vae.py:1118-1122).
        return (_leaf(f"{base}.norm3.norm", leaf), _identity)
    if child == "conv_shortcut":
        return (
            f"{base}.conv_shortcut."
            + ("weight" if leaf == "kernel" else "bias"),
            _conv3d if leaf == "kernel" else _identity,
        )
    if child == "scale_shift_table":
        return (f"{base}.scale_shift_table", _identity)
    if child in ("per_channel_scale1", "per_channel_scale2"):
        # torch (C, 1, 1) -> our (C,).
        return (f"{base}.{child}", _per_channel)
    return None


def _ltx_midblock(base: str, rest: Tuple[str, ...]):
    top, leaf = rest[0], rest[-1]
    m = _LTX_RES_RE.match(top)
    if m:
        return _ltx_resnet(f"{base}.res_blocks.{m.group(1)}", rest[1:])
    m = _LTX_ATTN_RE.match(top)
    if m:
        ab = f"{base}.attention_blocks.{m.group(1)}"
        child = rest[1]
        if child in ("to_q", "to_k", "to_v"):
            return (_leaf(f"{ab}.{child}", leaf), _dense if leaf == "kernel" else _identity)
        if child == "to_out":
            return (_leaf(f"{ab}.to_out.0", leaf), _dense if leaf == "kernel" else _identity)
        if child == "q_norm":
            return (f"{ab}.norm_q.weight", _identity)
        if child == "k_norm":
            return (f"{ab}.norm_k.weight", _identity)
        return None
    if top == "time_embedder":
        lin = {"fc1": "linear_1", "fc2": "linear_2"}[rest[1]]
        return (
            _leaf(f"{base}.time_embedder.timestep_embedder.{lin}", leaf),
            _dense if leaf == "kernel" else _identity,
        )
    return None


def import_ltx_vae_params(
    module: nn.Module, sd: Dict[str, Array], strict: bool = True
) -> nn.Module:
    """Import a reference `CausalVideoAutoencoder` state_dict into the
    port's `autoencoders.ltx_vae` autoencoder's `ae` module.
    Handles the full block grammar (res_x / res_x_y / compress_* /
    attn_res_x / DepthToSpaceUpsample), CausalConv3d vs DualConv3d
    kernels, pixel/group/layer norms, noise-injection scales, and the
    denoising-decoder timestep tables; `loss.*` keys are ignored."""

    def resolve(path: Tuple[str, ...]) -> Optional[Tuple[str, Transform]]:
        tower, leaf = path[0], path[-1]
        if tower in ("quant_conv", "post_quant_conv"):
            return (
                _leaf(tower, leaf),
                _conv3d if leaf == "kernel" else _identity,
            )
        if tower not in ("encoder", "decoder"):
            return None
        blocks = "down_blocks" if tower == "encoder" else "up_blocks"
        top = path[1]
        rest = path[2:]

        if top in ("conv_in", "conv_out"):
            return _ltx_conv(f"{tower}.{top}", rest)
        if top == "conv_norm_out":
            return _ltx_norm(f"{tower}.conv_norm_out", rest)
        if top == "timestep_scale_multiplier":
            return (f"{tower}.timestep_scale_multiplier", _scalar_param)
        if top == "last_scale_shift_table":
            return (f"{tower}.last_scale_shift_table", _identity)
        if top == "last_time_embedder":
            lin = {"fc1": "linear_1", "fc2": "linear_2"}[path[2]]
            return (
                _leaf(
                    f"{tower}.last_time_embedder.timestep_embedder.{lin}",
                    leaf,
                ),
                _dense if leaf == "kernel" else _identity,
            )

        m = _LTX_TOP_RE.match(top)
        if m is None:
            return None
        i, kind = m.group(2), m.group(3)
        base = f"{tower}.{blocks}.{i}"
        if kind in ("res_x", "attn_res_x"):
            return _ltx_midblock(base, rest)
        if kind == "res_x_y":
            return _ltx_resnet(base, rest)
        if kind.startswith("compress"):
            if tower == "decoder":
                # DepthToSpaceUpsample wraps its conv (ltx_vae.py:1389).
                return _ltx_conv(f"{base}.conv", rest[1:])
            return _ltx_conv(base, rest)
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


# -- HunyuanVideo causal-3D VAE (reference autoencoders/hunyuan.py:34-1545) --

_HY_RES_RE = re.compile(r"^(down|up)_(\d+)_res_(\d+)$")
_HY_RESAMPLE_RE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")
_HY_MID_RES_RE = re.compile(r"^res_(\d+)$")
_HY_MID_ATTN_RE = re.compile(r"^attn_(\d+)$")


def _hy_causal_conv(base: str, rest: Tuple[str, ...]):
    """Our CausalConv3d wraps nn.Conv 'conv'; reference CausalConv3d wraps
    nn.Conv3d 'conv' (hunyuan.py:801)."""
    leaf = rest[-1]
    return (
        f"{base}.conv." + ("weight" if leaf == "kernel" else "bias"),
        _conv3d if leaf == "kernel" else _identity,
    )


def _hy_resnet(base: str, rest: Tuple[str, ...]):
    child, leaf = rest[0], rest[-1]
    if child in ("norm1", "norm2"):
        return (_leaf(f"{base}.{child}", leaf), _identity)
    if child in ("conv1", "conv2", "conv_shortcut"):
        return _hy_causal_conv(f"{base}.{child}", rest[1:])
    return None


def _hy_midblock(base: str, rest: Tuple[str, ...]):
    top, leaf = rest[0], rest[-1]
    m = _HY_MID_RES_RE.match(top)
    if m:
        return _hy_resnet(f"{base}.resnets.{m.group(1)}", rest[1:])
    m = _HY_MID_ATTN_RE.match(top)
    if m:
        ab = f"{base}.attentions.{m.group(1)}"
        child = rest[1]
        if child == "group_norm":
            return (_leaf(f"{ab}.group_norm", leaf), _identity)
        if child in ("to_q", "to_k", "to_v"):
            return (
                _leaf(f"{ab}.{child}", leaf),
                _dense if leaf == "kernel" else _identity,
            )
        if child == "to_out":
            return (
                _leaf(f"{ab}.to_out.0", leaf),
                _dense if leaf == "kernel" else _identity,
            )
    return None


def import_hunyuan_vae_params(
    module: nn.Module, sd: Dict[str, Array], strict: bool = True
) -> nn.Module:
    """Import a reference `HunyuanCausal3DVAE` state_dict into the
    port's `autoencoders.hunyuan` autoencoder's `ae` module.
    Covers the Down/UpEncoderBlockCausal3D stacks, the frame-causal
    mid-block attention (single head, group-normed), and the 1x1 quant
    convs; `loss.*` keys are ignored."""

    def resolve(path: Tuple[str, ...]) -> Optional[Tuple[str, Transform]]:
        tower, leaf = path[0], path[-1]
        if tower in ("quant_conv", "post_quant_conv"):
            return (
                _leaf(tower, leaf),
                _conv3d if leaf == "kernel" else _identity,
            )
        if tower not in ("encoder", "decoder"):
            return None
        blocks = "down_blocks" if tower == "encoder" else "up_blocks"
        top = path[1]
        rest = path[2:]

        if top in ("conv_in", "conv_out"):
            return _hy_causal_conv(f"{tower}.{top}", rest)
        if top == "conv_norm_out":
            return (_leaf(f"{tower}.conv_norm_out", leaf), _identity)
        if top == "mid_block":
            return _hy_midblock(f"{tower}.mid_block", rest)
        m = _HY_RES_RE.match(top)
        if m:
            return _hy_resnet(
                f"{tower}.{blocks}.{m.group(2)}.resnets.{m.group(3)}", rest
            )
        m = _HY_RESAMPLE_RE.match(top)
        if m:
            samplers = (
                "downsamplers" if m.group(3) == "downsample" else "upsamplers"
            )
            return _hy_causal_conv(
                f"{tower}.{blocks}.{m.group(2)}.{samplers}.0.conv", rest
            )
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)


def import_autoencoder_kl_params(
    module: nn.Module, sd: Dict[str, Array], strict: bool = True
) -> nn.Module:
    """Import a reference `AutoencoderKL` state_dict into the port's
    `autoencoders.kl.AutoencoderKL`'s `ae` module in place; returns it."""

    def resolve(path: Tuple[str, ...]) -> Optional[Tuple[str, Transform]]:
        top, leaf = path[0], path[-1]
        if top in ("quant_conv", "post_quant_conv"):
            return (_leaf(top, leaf), _conv2d if leaf == "kernel" else _identity)
        if top in ("encoder", "decoder"):
            return _resolve_coder(top, path[1:])
        return None

    return _apply_mapping(module, sd, resolve, strict=strict)
