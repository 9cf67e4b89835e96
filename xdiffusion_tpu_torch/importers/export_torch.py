"""Port parameters -> PyTorch-reference state_dict exporter (the inverse of
importers/torch_state_dict.py for the flagship UNet).

Counterpart of xdiffusion_tpu/importers/export_torch.py, on the port's
modules: each parameter is read in flax's layout (`weights.state_dict_to_flax`)
under its flax path, then laid out as the reference holds it. A model
trained in the port is written in the reference `score_networks/unet.py`
layout (reference checkpoint contract: training/image/train.py:582-604),
which is also the one reference-layout file to be had where none can be
downloaded.

Layout inversions mirror the importer exactly:
- flax Dense (I, O)        -> torch Linear (O, I)
- flax Conv HWIO           -> torch Conv2d OIHW
- fused qkv/kv Dense       -> torch Conv1d(k=1) with per-head (q,k,v)
  row interleaving (reference QKVAttention layout)
- proj_out Dense           -> torch Conv1d(k=1)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from xdiffusion_tpu_torch.importers.torch_state_dict import (
    _MIDDLE_RE,
    _PROJ_RE,
    _STAGE_RE,
    _qkv_interleave,
)
from xdiffusion_tpu_torch.weights import state_dict_to_flax

Array = np.ndarray


def _dense_T(w: Array) -> Array:
    return w.T


def _conv2d_T(w: Array) -> Array:
    """flax HWIO -> torch OIHW."""
    return w.transpose(3, 2, 0, 1)


def _dense_to_conv1d(w: Array) -> Array:
    """flax Dense kernel (I, O) -> torch Conv1d weight (O, I, 1)."""
    return w.T[:, :, None]


def export_unet_params(module: nn.Module, *, heads: int = 8, dim_head: int = 64
                       ) -> Dict[str, Array]:
    """Export the port's `score_networks.unet.Unet` into a reference UNet
    state_dict (float32 numpy tensors; wrap with torch.from_numpy to save).

    Mirrors the importer's UNet resolver in reverse; raises on any
    unmapped leaf so a silent partial export can't happen.
    """

    def attn_heads(channels: int) -> int:
        return heads if dim_head == -1 else channels // dim_head

    def leaf_name(base: str, leaf: str) -> str:
        if leaf in ("scale", "kernel", "weight", "embedding"):
            return base + ".weight"
        return base + "." + leaf

    sd: Dict[str, Array] = {}
    for path, w in state_dict_to_flax(module).items():
        sub = tuple(path.split("/"))
        top, leaf = sub[0], sub[-1]

        m = _PROJ_RE.match(top)
        if m:
            base = f"_projections.{m.group(1)}"
            if sub[1] == "fc1":
                sd[leaf_name(f"{base}._projection.1", leaf)] = (
                    _dense_T(w) if leaf == "kernel" else w)
                continue
            if sub[1] == "fc2":
                sd[leaf_name(f"{base}._projection.3", leaf)] = (
                    _dense_T(w) if leaf == "kernel" else w)
                continue
            if sub[1] in ("embed", "table"):
                sd[f"{base}.embedding_table.weight"] = w
                continue
        if top == "_label_projection":
            sd["_label_projection.weight"] = w
            continue
        if top == "initial_conv":
            sd["_initial_convolution.weight"] = _conv2d_T(w)
            continue
        if top == "final_norm":
            sd[leaf_name("final_projection.0", leaf)] = w
            continue
        if top == "final_conv":
            sd["final_projection.2.weight"] = _conv2d_T(w)
            continue

        m = _STAGE_RE.match(top) or _MIDDLE_RE.match(top)
        if m is None:
            raise KeyError(f"unmapped flax path in export: {path}")
        if m.re is _MIDDLE_RE:
            base = f"middle.{m.group(1)}"
            pyramid = "middle"
        else:
            pyramid, i, j = m.group(1), m.group(2), m.group(3)
            base = f"{pyramid}.{i}.{j}"
        child = sub[1]

        biggan = {
            "norm1": "in_layers.0",
            "conv1": "in_layers.2",
            "emb_proj": "emb_layers.1",
            "norm2": "out_layers.0",
            "conv2": "out_layers.3",
            "skip": "skip_connection",
        }
        if child in biggan:
            key = leaf_name(f"{base}.{biggan[child]}", leaf)
            if leaf == "kernel":
                sd[key] = _dense_T(w) if w.ndim == 2 else _conv2d_T(w)
            else:
                sd[key] = w
            continue
        if child in ("qkv", "encoder_kv"):
            parts = 3 if child == "qkv" else 2
            c = (w.shape[-1] if w.ndim == 2 else w.shape[0]) // parts
            tf = _qkv_interleave(parts, attn_heads(c), conv1d=True)
            sd[leaf_name(f"{base}._{child}", leaf)] = tf(w)
            continue
        if child == "proj_out":
            if leaf == "kernel":
                sd[f"{base}._proj_out.weight"] = _dense_to_conv1d(w)
            else:
                sd[f"{base}._proj_out.bias"] = w
            continue
        if child == "norm":
            sd[leaf_name(f"{base}._norm", leaf)] = w
            continue
        if child == "context_norm":
            sd[leaf_name(f"{base}._context_layer_norm", leaf)] = w
            continue
        if child == "conv":
            op = "op" if pyramid == "downs" else "conv"
            if leaf == "kernel":
                sd[f"{base}.{op}.weight"] = _conv2d_T(w)
            else:
                sd[f"{base}.{op}.bias"] = w
            continue
        raise KeyError(f"unmapped flax path in export: {path}")
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}
