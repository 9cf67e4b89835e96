"""Perceptual (LPIPS-style) and wavelet reconstruction distances.

Counterpart of `perceptual_distance`, `haar_dwt3` and `wavelet_loss_3d` in
xdiffusion_tpu/autoencoders/perceptual.py: the multi-scale distance of
channel-normalised features of a five-stage conv pyramid, its filters the
trained bank (a digit classifier's) that the port keeps as
autoencoders/assets/perceptual_filters.npz, a byte-identical copy of the
JAX package's. The search order is the JAX package's:
$XDIFFUSION_DATA_DIR/perceptual/filters.npz, then the asset;
XDIFFUSION_PERCEPTUAL=random takes the seeded random pyramid (numpy's
generator, the same filters). The filters are constants: no gradient, no
parameter. The bank's training (the JAX package's
`train_perceptual_filters`, a tool that writes the asset) is not ported.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import same_padding

# Feature pyramid geometry: (out_channels, downsample) per stage.
_STAGES: Tuple[Tuple[int, bool], ...] = ((16, False), (32, True), (64, True), (128, True),
                                         (128, True))

_TRAINED_CACHE: Dict = {}
_DEVICE_CACHE: Dict = {}


def _seeded_filters(in_ch: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """He-scaled HWIO kernels and biases from numpy's seeded generator."""
    rng = np.random.default_rng(20260816)
    filters, c = [], in_ch
    for out, _ in _STAGES:
        w = rng.standard_normal((3, 3, c, out)).astype(np.float32)
        w *= np.sqrt(2.0 / (3 * 3 * c))
        b = (0.2 * rng.standard_normal(out)).astype(np.float32)
        filters.append((w, b))
        c = out
    return filters


def _filters_search_paths() -> List[str]:
    paths = []
    data_dir = os.environ.get("XDIFFUSION_DATA_DIR")
    if data_dir:
        paths.append(os.path.join(data_dir, "perceptual", "filters.npz"))
    paths.append(os.path.join(os.path.dirname(__file__), "assets", "perceptual_filters.npz"))
    return paths


def load_trained_filters(in_ch: int = 3):
    """The trained filter bank [(w HWIO, b) per stage], or None. Cached."""
    if os.environ.get("XDIFFUSION_PERCEPTUAL") == "random":
        return None
    for path in _filters_search_paths():
        key = (path, in_ch)
        if key in _TRAINED_CACHE:
            if _TRAINED_CACHE[key] is not None:
                return _TRAINED_CACHE[key]
            continue
        if not os.path.exists(path):
            _TRAINED_CACHE[key] = None
            continue
        with np.load(path) as data:
            filters = [(data[f"w{i}"].astype(np.float32), data[f"b{i}"].astype(np.float32))
                       for i in range(len(_STAGES))]
        ok = filters[0][0].shape[2] == in_ch
        _TRAINED_CACHE[key] = filters if ok else None
        if ok:
            return filters
    return None


def _device_filters(in_ch: int, device: torch.device):
    """The filters as (OIHW, bias) tensors on `device`, cached per source."""
    trained = load_trained_filters(in_ch)
    key = ("seeded" if trained is None else id(trained), in_ch, str(device))
    if key not in _DEVICE_CACHE:
        filters = trained or _seeded_filters(in_ch)
        _DEVICE_CACHE[key] = [(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().to(device),
                               torch.from_numpy(b).to(device)) for w, b in filters]
    return _DEVICE_CACHE[key]


def _features(x: torch.Tensor, filters) -> List[torch.Tensor]:
    """x: (B, H, W, C) -> the stages' (B, C', H', W') maps, channels first."""
    feats, h = [], x.permute(0, 3, 1, 2)
    for (w, b), (_, down) in zip(filters, _STAGES):
        s = 2 if down else 1
        (t, bo), (le, r) = (same_padding(n, 3, s) for n in h.shape[2:])
        h = F.relu(F.conv2d(F.pad(h, (le, r, t, bo)), w, b, stride=s))
        feats.append(h)
    return feats


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (torch.sqrt(torch.sum(feat.square(), dim=1, keepdim=True)) + eps)


def perceptual_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, [F,] H, W, C) pairs -> (B, 1, 1, 1[, 1]): the stages' mean squared
    distance of normalised features, summed; a video's frames fold into the
    batch and average. One channel is tiled to three."""
    video = x.ndim == 5
    b = x.shape[0]
    if video:
        f = x.shape[1]
        x, y = x.reshape(-1, *x.shape[2:]), y.reshape(-1, *y.shape[2:])
    if x.shape[-1] == 1:
        x, y = x.expand(*x.shape[:-1], 3), y.expand(*y.shape[:-1], 3)
    filters = _device_filters(x.shape[-1], x.device)
    total = None
    for a, c in zip(_features(x, filters), _features(y, filters)):
        d = torch.mean(torch.square(_normalize(a) - _normalize(c)), dim=(1, 2, 3))
        total = d if total is None else total + d
    if video:
        return total.reshape(b, f).mean(dim=1).reshape(b, 1, 1, 1, 1)
    return total.reshape(b, 1, 1, 1)


def haar_dwt3(x: torch.Tensor) -> torch.Tensor:
    """One level of the 3-D Haar DWT: (B, F, H, W, C) -> (B, 8, F', H', W', C),
    the subbands stacked on axis 1; an odd extent repeats its last entry."""
    for axis in (1, 2, 3):
        if x.shape[axis] % 2:
            x = torch.cat([x, x.narrow(axis, x.shape[axis] - 1, 1)], dim=axis)
    b, f, h, w, c = x.shape
    blocks = x.reshape(b, f // 2, 2, h // 2, 2, w // 2, 2, c)
    scale = 2.0 ** (-1.5)
    bands = []
    for sf, sh, sw in itertools.product((1.0, -1.0), repeat=3):
        signs = torch.tensor([[[1.0, sw], [sh, sh * sw]], [[sf, sf * sw], [sf * sh, sf * sh * sw]]],
                             dtype=x.dtype, device=x.device)
        bands.append(torch.einsum("bfihjwkc,ijk->bfhwc", blocks, signs) * scale)
    return torch.stack(bands, dim=1)


def wavelet_loss_3d(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the Haar subbands, averaged over the subbands and then the
    frames and pixels: (B, 1, 1, 1, C)."""
    d = torch.abs(haar_dwt3(recon) - haar_dwt3(target)).mean(dim=1)
    return d.mean(dim=(1, 2, 3), keepdim=True)
