"""A reference-layout EDM state dict (SongUNet / DhariwalUNet) into the
port's backbones (score_networks/edm.py).

Counterpart of xdiffusion_tpu/importers/edm.py, mapping onto the port's
modules directly. The port's module names are the JAX package's, and its
layouts the reference's own (Linear (out, in), Conv OIHW), so each leaf is a
rename; GroupNorm's `weight` is the port's `scale`. The one real transform
is the fused qkv 1x1 convolution, whose reference rows are ordered (head,
channel, part), where the port's Dense emits part-major (q, k, v) rows.
The helpers below are the port's own copies of the few that the JAX
importer takes from importers/torch_state_dict.py.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

Array = np.ndarray
Transform = Callable[[Array], Array]

_EDM_TOP_RE = re.compile(r"^(enc|dec)_(\d+x\d+)_(.+)$")


def _as_np(t) -> Array:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _identity(w: Array) -> Array:
    return w


# The reference's Linear and Conv2d layouts are the port's.
_dense = _identity
_conv2d = _identity


def _leaf_name(torch_base: str, leaf: str) -> str:
    """A port leaf's reference key: GroupNorm `scale` (and any `weight`) is
    `.weight`, the rest keep their names."""
    if leaf in ("scale", "weight"):
        return torch_base + ".weight"
    return torch_base + "." + leaf


def _apply_mapping(target: Mapping[str, torch.Tensor], sd: Mapping[str, Array],
                   resolve: Callable[[Tuple[str, ...]], Optional[Tuple[str, Transform]]],
                   strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port state dict `target` with each leaf that `resolve(path)`
    names taken from `sd` (transformed); a leaf it does not name, or (not
    `strict`) whose key `sd` lacks, keeps its value."""
    out, missing = {}, []
    for name, value in target.items():
        found = resolve(tuple(name.split(".")))
        if found is None:
            out[name] = value
            continue
        key, tf = found
        if key not in sd:
            missing.append((name, key))
            out[name] = value
            continue
        arr = np.ascontiguousarray(tf(_as_np(sd[key])))
        if tuple(arr.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch importing {key} -> {name}: {arr.shape} vs "
                             f"{tuple(value.shape)}")
        out[name] = torch.from_numpy(arr).to(dtype=value.dtype)
    if missing and strict:
        raise KeyError("reference state dict is missing keys for port parameters:\n"
                       + "\n".join(f"  {n} <- {k}" for n, k in missing))
    return out


def _edm_qkv(num_heads: int) -> Transform:
    """(head, channel, part)-interleaved qkv rows -> part-major rows."""

    def tf(w: Array) -> Array:
        if w.ndim == 4:  # conv 1x1 weight (3C, C, 1, 1)
            w = w[:, :, 0, 0]
        out = w.shape[0]
        cph = out // (3 * num_heads)
        if w.ndim == 1:
            return w.reshape(num_heads, cph, 3).transpose(2, 0, 1).reshape(out)
        return w.reshape(num_heads, cph, 3, w.shape[1]).transpose(2, 0, 1, 3).reshape(out, -1)

    return tf


def _conv1x1_dense(w: Array) -> Array:
    """Conv2d(k=1) weight (O, I, 1, 1) -> Linear (O, I)."""
    return w[:, :, 0, 0]


def _song_aux(sd: Mapping[str, Array], kind: str) -> str:
    """The SongUNet's output head at dec.{R}x{R}_aux_{norm,conv}, the largest R."""
    pat = re.compile(rf"^dec\.(\d+)x(\d+)_aux_{kind}\.weight$")
    best = None
    for k in sd:
        m = pat.match(k)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), k[: -len(".weight")])
    if best is None:
        raise KeyError(f"no aux_{kind} head in state_dict")
    return best[1]


def import_edm_unet_params(module: nn.Module, sd: Mapping[str, Array], *, arch: str = "song",
                           channels_per_head: int = 64, strict: bool = True) -> nn.Module:
    """Loads the reference state dict `sd` into the port's SongUNet /
    DhariwalUNet `module` and returns it. arch='song' has one attention
    head; arch='adm' C / channels_per_head. Not `strict`: a leaf `sd` lacks
    keeps its value."""

    def attn_heads(c: int) -> int:
        return 1 if arch == "song" else max(1, c // channels_per_head)

    def block_child(base: str, child: str, leaf: str):
        if child in ("norm0", "norm1", "norm2"):
            return _leaf_name(f"{base}.{child}", leaf), _identity
        if child in ("conv0", "conv1", "skip"):
            return f"{base}.{child}.{leaf}", _conv2d
        if child == "affine":
            return f"{base}.affine.{leaf}", _dense
        if child == "qkv":
            def tf(w):
                return _edm_qkv(attn_heads(w.shape[0] // 3))(w)

            return _leaf_name(f"{base}.qkv", leaf), tf
        if child == "proj":
            return f"{base}.proj.{leaf}", _conv1x1_dense if leaf == "weight" else _identity
        return None

    def resolve(path: Tuple[str, ...]):
        top, leaf = path[0], path[-1]
        if top == "map_noise":  # the Fourier frequencies
            return "map_noise.freqs", _identity
        if top in ("map_layer0", "map_layer1", "map_label", "map_augment"):
            return f"{top}.{leaf}", _dense
        if top in ("out_norm", "out_conv"):
            kind = top[4:]
            key = top if f"{top}.weight" in sd else _song_aux(sd, kind)
            return _leaf_name(key, leaf), _identity
        m = _EDM_TOP_RE.match(top)
        if m is None:
            return None
        base = f"{m.group(1)}.{m.group(2)}_{m.group(3)}"
        if m.group(3) in ("conv", "aux_residual"):  # the stem; FusedDownConv's one conv
            return f"{base}.{leaf}", _conv2d
        return block_child(base, path[1], leaf)

    module.load_state_dict(_apply_mapping(module.state_dict(), sd, resolve, strict=strict))
    return module
