"""Long-video sampling schemes (windowed autoregressive generation).

The port's copy of xdiffusion_tpu/samplers/schemes.py: an iterator that
yields, per window, the observed frame indices, the latent frame indices
and the window's temporal mask, so that a model of `max_frames` frames
generates a video of any length. Host control flow; each window is one
`sample()` call (sample_video.py). Mask convention: True = generate
(latent), False = observed.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class SamplingSchemeBase:
    def __init__(self, video_length: int, num_observed_frames: int, max_frames: int,
                 step_size: int, **kwargs):
        self._video_length = int(video_length)
        self._max_frames = int(max_frames)
        self._num_obs = int(num_observed_frames)
        self._done_frames = set(range(self._num_obs))
        self._obs_frames = list(range(self._num_obs))
        self._step_size = int(step_size)
        self._current_step = 0
        self.B: Optional[int] = None

    def get_unconditional_indices(self) -> List[int]:
        return list(range(self._max_frames))

    def set_videos(self, videos) -> None:
        self.B = len(videos)

    @property
    def num_observations(self) -> int:
        return self._num_obs

    @property
    def video_length(self) -> int:
        return self._video_length

    def is_done(self) -> bool:
        return len(self._done_frames) >= self._video_length

    def __iter__(self):
        return self

    def next_indices(self) -> Tuple[List[int], List[int]]:
        raise NotImplementedError

    def __next__(self):
        if self.is_done():
            raise StopIteration
        unconditional = False
        if self._num_obs == 0 and self._current_step == 0:
            obs_frame_indices: List[int] = []
            latent_frame_indices = self.get_unconditional_indices()
            unconditional = True
        else:
            obs_frame_indices, latent_frame_indices = self.next_indices()

        for idx in obs_frame_indices:
            assert idx in self._done_frames, f"conditioning on frame {idx} before it is generated"
        assert all(i < self._video_length for i in latent_frame_indices)
        self._done_frames.update(latent_frame_indices)
        if unconditional:
            self._obs_frames = latent_frame_indices
        self._current_step += 1

        batch = self.B if self.B is not None else 1
        obs_batched = [obs_frame_indices] * batch
        latent_batched = [latent_frame_indices] * batch

        # (B, max_frames) temporal mask; the observed window slots are False.
        mask = np.ones((batch, self._max_frames), dtype=bool)
        offset = self._step_size * (self._current_step - 1)
        for b in range(batch):
            for frame_idx in obs_batched[b]:
                rel = frame_idx - offset
                assert 0 <= rel < self._max_frames, f"observed frame {frame_idx} outside window"
                mask[b][rel] = False
        if self.B is None:
            return obs_frame_indices, latent_frame_indices, mask
        return obs_batched, latent_batched, mask


class Autoregressive(SamplingSchemeBase):
    """Slides a max_frames window forward step_size frames at a time, each
    window conditioned on the last max_frames - step_size frames done."""

    def next_indices(self) -> Tuple[List[int], List[int]]:
        if len(self._done_frames) == 0:
            return [], list(range(self._max_frames))
        obs = sorted(self._done_frames)[-(self._max_frames - self._step_size):]
        first = obs[-1] + 1
        latent = list(range(first, min(first + self._step_size, self._video_length)))
        return obs, latent
