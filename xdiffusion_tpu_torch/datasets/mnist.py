"""MNIST (and inverted variant) dataset.

Counterpart of xdiffusion_tpu/datasets/mnist.py. Reads IDX archives from
$XDIFFUSION_DATA_DIR (default <repo>/data) when they are there; otherwise
serves the deterministic synthetic stand-in (datasets/synthetic.py) under
the JAX package's seeds. Images are bilinearly resized once at load to the
configured spatial size (numpy, after `jax.image.resize`) and held in
memory as uint8; batches convert to float32 [0, 1] on the way out.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Optional, Tuple

import numpy as np


def data_root() -> str:
    return os.environ.get(
        "XDIFFUSION_DATA_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "data"),
    )


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find_idx(base: str, names: List[str]) -> Optional[str]:
    for name in names:
        for suffix in ("", ".gz"):
            p = os.path.join(base, name + suffix)
            if os.path.exists(p):
                return p
    return None


def _load_real_mnist(split: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    base_candidates = [
        os.path.join(data_root(), "mnist"),
        os.path.join(data_root(), "MNIST", "raw"),
    ]
    prefix = "train" if split == "train" else "t10k"
    for base in base_candidates:
        img_p = _find_idx(base, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
        lab_p = _find_idx(base, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
        if img_p and lab_p:
            images = _read_idx(img_p)[..., None]  # (N, 28, 28, 1)
            labels = _read_idx(lab_p).astype(np.int32)
            return images, labels
    return None


def _bilinear_weights(input_size: int, output_size: int) -> np.ndarray:
    """(input_size, output_size) fp32 interpolation weights, computed as
    `jax.image.resize` computes them (half-pixel centres, triangle kernel,
    columns normalised to sum 1, no antialiasing when upsampling)."""
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(output_size, dtype=np.float32) + np.float32(0.5))
                * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float32)[:, None])
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x / kernel_scale))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)),
                       np.float32(0.0)).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def _resize_bilinear(images: np.ndarray, size: int) -> np.ndarray:
    """One-time host resize (N, H, W, C) uint8 -> (N, size, size, C) uint8."""
    if images.shape[1] == size:
        return images
    wh = _bilinear_weights(images.shape[1], size)
    ww = _bilinear_weights(images.shape[2], size)
    x = images.astype(np.float32)
    x = np.einsum("nhwc,hy->nywc", x, wh, optimize=False)
    x = np.einsum("nywc,wx->nyxc", x, ww, optimize=False)
    return np.clip(x, 0, 255).astype(np.uint8)


class MNIST:
    """In-memory image dataset: uint8 (N, S, S, 1) + int labels."""

    num_classes = 10

    def __init__(
        self,
        split: str = "train",
        image_size: int = 32,
        invert: bool = False,
        num_synthetic: int = 60000,
    ):
        real = _load_real_mnist(split)
        if real is not None:
            images, labels = real
            self.synthetic = False
        else:
            from xdiffusion_tpu_torch.datasets.synthetic import generate_digits

            seed = 0 if split == "train" else 1
            n = num_synthetic if split == "train" else max(1, num_synthetic // 6)
            images, labels = generate_digits(n, seed=seed)
            self.synthetic = True
        images = _resize_bilinear(images, image_size)
        if invert:
            images = 255 - images
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx) -> Tuple[np.ndarray, int]:
        return (
            self.images[idx].astype(np.float32) / 255.0,
            int(self.labels[idx]),
        )


# Two textual surface forms per digit, matching the reference's
# label->prompt behavior (datasets/mnist.py:65).
_TEXT_FORMS = [
    ["zero", "0"],
    ["one", "1"],
    ["two", "2"],
    ["three", "3"],
    ["four", "4"],
    ["five", "5"],
    ["six", "6"],
    ["seven", "7"],
    ["eight", "8"],
    ["nine", "9"],
]


def convert_labels_to_prompts(labels: np.ndarray,
                              rng: Optional[np.random.Generator] = None) -> List[str]:
    """A surface form per label drawn from `rng`, e.g. 3 -> 'three' or '3'.
    Without `rng` the draws are unseeded, as in the JAX package; the
    trainer passes np.random.default_rng((seed, step)), so a resumed run
    repeats the prompts."""
    labels = np.asarray(labels)
    rng = rng or np.random.default_rng()
    picks = rng.integers(0, 2, size=labels.shape[0])
    return [_TEXT_FORMS[int(l)][int(p)] for l, p in zip(labels, picks)]
