"""Labelled Moving-MNIST-256: 100 videos of 30 frames at 256x256, two
digits each.

The port's copy of xdiffusion_tpu/datasets/moving_mnist_256.py. It reads
`MovingMNIST256/videos_data.npz` (a flat (N*30, 256, 256) uint8 frame
stream) and `labels_data.npz` ((N*30, 2) digit labels) under
$XDIFFUSION_DATA_DIR or the working directory when both are there, and
otherwise synthesises the bouncing digits at 256x256 (two a video, 30
frames, seed 0). The videos are resized once to the training size, clipped
to [0, 255] and truncated to uint8. The resize takes `jax.image.resize`'s
antialiased bilinear weights (datasets/mnist.py `_bilinear_weights`) as two
matrix products, which sum in another order than XLA's, so a value next to
an integer can truncate to the level below or above the JAX package's.
Prompts name both digits ("three and 7").
"""

from __future__ import annotations

import os

import numpy as np

from xdiffusion_tpu_torch.datasets.mnist import _bilinear_weights, data_root
from xdiffusion_tpu_torch.datasets.moving_mnist import (  # noqa: F401 (its prompts)
    convert_labels_to_prompts,
    synthesize_moving_mnist,
)

NATIVE_SIZE = 256
NATIVE_FRAMES = 30
DIGITS_PER_VIDEO = 2


def _load_archive():
    for root in (data_root(), "."):
        vpath = os.path.join(root, "MovingMNIST256", "videos_data.npz")
        lpath = os.path.join(root, "MovingMNIST256", "labels_data.npz")
        if os.path.exists(vpath) and os.path.exists(lpath):
            with np.load(vpath, allow_pickle=True) as npz:
                videos = npz[npz.files[0]]
            with np.load(lpath, allow_pickle=True) as npz:
                labels = npz[npz.files[0]]
            n = videos.shape[0] // NATIVE_FRAMES
            videos = np.asarray(videos, dtype=np.uint8).reshape(
                n, NATIVE_FRAMES, NATIVE_SIZE, NATIVE_SIZE, 1)
            labels = np.asarray(labels).reshape(n, NATIVE_FRAMES, -1)[:, 0, :]
            return videos, labels.astype(np.int32)
    return None


def _resize_videos(videos: np.ndarray, size: int) -> np.ndarray:
    """(N, F, S, S, 1) uint8 -> (N, F, size, size, 1) uint8, bilinear: the
    rows' weights, then the columns', as fp32 matrix products, 512 frames
    at a time."""
    if videos.shape[2] == size:
        return videos
    n, f, s, _, c = videos.shape
    wh = _bilinear_weights(s, size).T  # (size, S)
    ww = _bilinear_weights(s, size)  # (S, size)
    flat = videos[..., 0].reshape(n * f, s, s)
    out = np.empty((n * f, size, size), dtype=np.uint8)
    for i in range(0, flat.shape[0], 512):
        x = np.matmul(np.matmul(wh, flat[i:i + 512].astype(np.float32)), ww)
        out[i:i + 512] = np.clip(x, 0, 255).astype(np.uint8)
    return out.reshape(n, f, size, size, c)


class MovingMNIST256:
    """In-memory video dataset: uint8 (N, F, S, S, 1) and (N, 2) labels."""

    num_classes = 10

    def __init__(self, split: str = "train", image_size: int = 64, num_videos: int = 100):
        assert split == "train", "the 256 variant ships a train split only"
        real = _load_archive()
        if real is not None:
            videos, labels = real
            self.synthetic = False
        else:
            videos, labels = synthesize_moving_mnist(
                num_videos, num_frames=NATIVE_FRAMES, image_size=NATIVE_SIZE,
                digits_per_video=DIGITS_PER_VIDEO, seed=0)
            self.synthetic = True
        self.videos = _resize_videos(videos, image_size)
        self.labels = labels

    def __len__(self) -> int:
        return self.videos.shape[0]

    def __getitem__(self, idx):
        return self.videos[idx].astype(np.float32) / 255.0, self.labels[idx]
