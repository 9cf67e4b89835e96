"""Video training batch preparation, host numpy.

The port's copy of xdiffusion_tpu/training_utils.py: frames cropped or
tiled to the model's input length and resized to its size, the frame
indices and the frame mask (`preprocess_training_videos`); the
single-frame "image batches" of joint image/video training
(`get_training_batch`); and Flexible Diffusion Modeling's batches
(`fdm_random_mask`, `sample_fdm_training_batch`): random latent and
observed frame subsets, gathered with their source frame indices. For the
same `np.random.Generator` the outputs equal the JAX package's bit for bit,
draw for draw. The resize (`jax.image.resize` there) is `resize_bilinear`
(layers/super_resolution.py), antialiased like it, to fp32 rounding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def fdm_random_mask(batch: int, num_frames: int, rng: Optional[np.random.Generator] = None,
                    max_obs: Optional[int] = None) -> np.ndarray:
    """FDM-style random frame masks: per example a random subset (possibly
    empty) of at most `max_obs` frames is observed. True = generate, False
    = condition."""
    rng = rng or np.random.default_rng()
    max_obs = max_obs if max_obs is not None else num_frames - 1
    masks = np.ones((batch, num_frames), dtype=bool)
    for b in range(batch):
        n_obs = int(rng.integers(0, max_obs + 1))
        if n_obs > 0:
            masks[b, rng.choice(num_frames, size=n_obs, replace=False)] = False
    return masks


def _sample_some_indices(rng: np.random.Generator, max_indices: int, num_frames: int) -> list:
    """A random geometric-spaced subset of frame indices, drawn again until
    every index is in range."""
    s = int(rng.integers(1, max_indices + 1))
    max_scale = num_frames / (s - 0.999)
    scale = np.exp(rng.random() * np.log(max_scale))
    pos = rng.random() * (num_frames - scale * (s - 1))
    indices = [int(pos + i * scale) for i in range(s)]
    if all(0 <= i < num_frames for i in indices):
        return indices
    return _sample_some_indices(rng, max_indices, num_frames)


def sample_fdm_training_batch(videos: np.ndarray, max_frames: int, method: str = "random",
                              rng: Optional[np.random.Generator] = None):
    """Flexible Diffusion Modeling's training batch: per example, random
    latent (generated) and observed (conditioning) frame subsets of the
    source clip, the selected frames gathered and padded with random ones,
    and their source indices. "uniform": the first `max_frames` frames, all
    latent.

    videos: (B, T, H, W, C). Returns (videos (B, N, H, W, C), frame_indices
    (B, N) int32, observed_mask (B, N) float32, latent_mask (B, N)
    float32)."""
    rng = rng or np.random.default_rng()
    b, t = videos.shape[:2]
    n = max_frames
    if method == "uniform":
        return (videos[:, :n], np.tile(np.arange(n, dtype=np.int32)[None], (b, 1)),
                np.zeros((b, n), np.float32), np.ones((b, n), np.float32))

    obs = np.zeros((b, t), np.float32)
    lat = np.zeros((b, t), np.float32)
    for i in range(b):
        lat[i, _sample_some_indices(rng, n, t)] = 1.0
        while True:
            remaining = n - obs[i].sum() - lat[i].sum()
            if remaining <= 0:  # every slot taken (t == n)
                break
            mask = obs[i] if rng.random() < 0.5 else lat[i]
            idx = np.asarray(_sample_some_indices(rng, n, t))
            idx = idx[(obs[i, idx] + lat[i, idx]) == 0]
            if len(idx) > remaining:
                break
            mask[idx] = 1.0

    any_mask = np.clip(obs + lat, 0.0, 1.0)
    fi = np.zeros((b, n), np.int64)
    new_v = np.zeros((b, n) + videos.shape[2:], videos.dtype)
    new_obs = np.zeros((b, n), np.float32)
    new_lat = np.zeros((b, n), np.float32)
    for i in range(b):
        sel = np.nonzero(any_mask[i])[0]
        k = len(sel)
        fi[i, :k] = sel
        if k < n:
            fi[i, k:] = rng.integers(0, t, size=n - k)
        new_v[i] = videos[i][fi[i]]
        new_obs[i] = obs[i][fi[i]]
        new_lat[i] = lat[i][fi[i]]
    return new_v, fi.astype(np.int32), new_obs, new_lat


def _resize_video(videos: np.ndarray, size: int) -> np.ndarray:
    """(B, F, H, W, C) -> (B, F, size, size, C) float32, bilinear with
    `jax.image.resize`'s antialiasing (`resize_bilinear`)."""
    if videos.shape[2] == size and videos.shape[3] == size:
        return videos
    from xdiffusion_tpu_torch.layers.super_resolution import resize_bilinear

    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(videos)), size).numpy()


def preprocess_training_videos(
    videos: np.ndarray,
    config,
    mask_generator=None,
    rng: Optional[np.random.Generator] = None,
    frames: Optional[int] = None,
    size: Optional[int] = None,
) -> Tuple[np.ndarray, Dict]:
    """Clips or tiles frames to the model's input length, resizes them to
    its size and draws the per-example frame masks; `frames` and `size`
    replace the score network's (a latent process's videos take its VAE's).

    videos: (B, F, H, W, C) float [0, 1]. Returns (videos', context update):
    `frame_indices` (B, F') int32 and, with a mask generator, `video_mask`
    (B, F') bool and `x0` None (the loss fills it with the clean frames)."""
    rng = rng or np.random.default_rng()
    sn = config.diffusion.score_network.params
    target_frames = int(frames or sn.get("input_number_of_frames", videos.shape[1]))
    size = size or sn.input_spatial_size
    target_size = int(size[0] if isinstance(size, list) else size)

    b, f = videos.shape[:2]
    if f > target_frames:
        start = int(rng.integers(0, f - target_frames + 1))
        videos = videos[:, start:start + target_frames]
    elif f < target_frames:
        reps = -(-target_frames // f)
        videos = np.tile(videos, (1, reps, 1, 1, 1))[:, :target_frames]
    videos = _resize_video(videos, target_size)

    context: Dict = {
        "frame_indices": np.tile(np.arange(target_frames, dtype=np.int32)[None], (b, 1)),
    }
    if mask_generator is not None:
        context["video_mask"] = mask_generator.get_masks(videos.shape, rng=rng)
        context["x0"] = None
    return videos, context


def get_training_batch(
    videos: np.ndarray,
    is_image_batch: bool,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Joint image/video training: an "image batch" is one random frame per
    example, shaped (B, 1, H, W, C) so both modes share the video model's
    signature; a video batch passes through."""
    if not is_image_batch:
        return videos
    rng = rng or np.random.default_rng()
    b, f = videos.shape[:2]
    idx = rng.integers(0, f, size=b)
    return videos[np.arange(b), idx][:, None]
