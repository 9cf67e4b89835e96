"""Moving-MNIST video dataset.

The port's copy of xdiffusion_tpu/datasets/moving_mnist.py. It never
downloads: it reads `moving_mnist_<split>.npz` (arrays `videos`, `labels`)
under $XDIFFUSION_DATA_DIR/moving_mnist, or the MovingMNIST256 archive
layout under $XDIFFUSION_DATA_DIR, when present, and otherwise synthesises
labelled bouncing digits from the procedural glyphs, bit for bit as the JAX
package does for the same seed. Videos are uint8 (N, F, H, W, 1) with
per-video digit labels (N, digits).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from xdiffusion_tpu_torch.datasets.mnist import _TEXT_FORMS, data_root
from xdiffusion_tpu_torch.datasets.synthetic import generate_digits


def synthesize_moving_mnist(
    num_videos: int,
    num_frames: int = 16,
    image_size: int = 32,
    digits_per_video: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bouncing-digit videos: uint8 (N, F, S, S, 1) + labels (N, digits)."""
    rng = np.random.default_rng(seed)
    glyph_images, glyph_labels = generate_digits(
        max(256, num_videos), seed=seed + 1, image_size=image_size
    )
    # Tight-crop each digit for compositing.
    crops: List[np.ndarray] = []
    for img in glyph_images[..., 0]:
        ys, xs = np.nonzero(img)
        if len(ys) == 0:
            crops.append(img[:10, :10])
        else:
            crops.append(img[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1])

    videos = np.zeros(
        (num_videos, num_frames, image_size, image_size, 1), dtype=np.uint8
    )
    labels = np.zeros((num_videos, digits_per_video), dtype=np.int32)
    for n in range(num_videos):
        for d in range(digits_per_video):
            gi = int(rng.integers(0, len(crops)))
            digit = crops[gi]
            labels[n, d] = glyph_labels[gi]
            h, w = digit.shape
            max_y, max_x = image_size - h, image_size - w
            y = float(rng.integers(0, max(1, max_y)))
            x = float(rng.integers(0, max(1, max_x)))
            vy = float(rng.uniform(-2.5, 2.5))
            vx = float(rng.uniform(-2.5, 2.5))
            for f in range(num_frames):
                yi, xi = int(round(y)), int(round(x))
                patch = videos[n, f, yi : yi + h, xi : xi + w, 0]
                np.maximum(patch, digit, out=patch)
                y += vy
                x += vx
                if y < 0 or y > max_y:
                    vy = -vy
                    y = float(np.clip(y, 0, max_y))
                if x < 0 or x > max_x:
                    vx = -vx
                    x = float(np.clip(x, 0, max_x))
    return videos, labels


def _load_real(split: str):
    """(videos, labels) from the archives under data_root(), or None."""
    path = os.path.join(data_root(), "moving_mnist", f"moving_mnist_{split}.npz")
    if os.path.exists(path):
        data = np.load(path)
        return data["videos"], data["labels"]
    # The MovingMNIST256 layout: a flat (N * 30, 256, 256) uint8 frame stream
    # and per-frame digit labels.
    vpath = os.path.join(data_root(), "MovingMNIST256", "videos_data.npz")
    lpath = os.path.join(data_root(), "MovingMNIST256", "labels_data.npz")
    if os.path.exists(vpath) and os.path.exists(lpath):
        videos = np.load(vpath)["arr_0"]
        labels = np.load(lpath)["arr_0"]
        num_frames = 30
        n = videos.shape[0] // num_frames
        return (videos.reshape(n, num_frames, 256, 256, 1),
                labels.reshape(n, num_frames, -1)[:, 0, :])
    return None


class MovingMNIST:
    """In-memory video dataset: uint8 (N, F, S, S, 1) + labels."""

    num_classes = 10

    def __init__(self, split: str = "train", image_size: int = 32, num_frames: int = 16,
                 num_videos: int = 2000):
        real = _load_real(split)
        if real is not None:
            self.videos, self.labels = real
            self.synthetic = False
        else:
            seed = 0 if split == "train" else 1
            n = num_videos if split == "train" else max(1, num_videos // 10)
            self.videos, self.labels = synthesize_moving_mnist(
                n, num_frames=num_frames, image_size=image_size, seed=seed)
            self.synthetic = True

    def __len__(self) -> int:
        return self.videos.shape[0]

    def __getitem__(self, idx):
        return self.videos[idx].astype(np.float32) / 255.0, self.labels[idx]


def convert_labels_to_prompts(labels: np.ndarray,
                              rng: Optional[np.random.Generator] = None) -> List[str]:
    """Digit labels -> prompts, one surface form per digit drawn from `rng`
    ("three" or "3"), several digits joined by " and ". Without `rng` the
    draws are unseeded, as in the JAX package."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[:, None]
    rng = rng or np.random.default_rng()
    return [" and ".join(_TEXT_FORMS[int(l)][int(rng.integers(0, 2))] for l in row)
            for row in labels]
