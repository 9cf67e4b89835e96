"""Video training batch preparation, host numpy.

The port's copy of `preprocess_training_videos` and `get_training_batch` of
xdiffusion_tpu/training_utils.py: frames cropped or tiled to the model's
input length, the frame indices and the frame mask; and the single-frame
"image batches" of joint image/video training. For the same
`np.random.Generator` the outputs equal the JAX package's bit for bit.

The spatial resize (`jax.image.resize` there) is not ported: videos must
arrive at the model's input size. The Flexible-Diffusion-Modeling batch
sampler is not ported either; the video trainer refuses configs that ask
for it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def preprocess_training_videos(
    videos: np.ndarray,
    config,
    mask_generator=None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Dict]:
    """Clips or tiles frames to the model's input length and draws the
    per-example frame masks.

    videos: (B, F, H, W, C) float [0, 1]. Returns (videos', context update):
    `frame_indices` (B, F') int32 and, with a mask generator, `video_mask`
    (B, F') bool and `x0` None (the loss fills it with the clean frames)."""
    rng = rng or np.random.default_rng()
    sn = config.diffusion.score_network.params
    target_frames = int(sn.get("input_number_of_frames", videos.shape[1]))
    size = sn.input_spatial_size
    target_size = int(size[0] if isinstance(size, list) else size)

    b, f = videos.shape[:2]
    if f > target_frames:
        start = int(rng.integers(0, f - target_frames + 1))
        videos = videos[:, start:start + target_frames]
    elif f < target_frames:
        reps = -(-target_frames // f)
        videos = np.tile(videos, (1, reps, 1, 1, 1))[:, :target_frames]
    if videos.shape[2] != target_size or videos.shape[3] != target_size:
        raise NotImplementedError(
            f"resizing {videos.shape[2]}x{videos.shape[3]} videos to the model's "
            f"{target_size}x{target_size} is not ported yet")

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
