"""UrbanSound8k log-mel spectrograms.

Counterpart of xdiffusion_tpu/datasets/urbansound8k.py: the precomputed
mels of `{data_root}/urbansound8k/melspec_{split}.npz` when present, else
the JAX package's offline synthesizer (class-pitched tones with a random
harmonic phase, amplitude modulation and noise, the same numpy draws)
through the real wav -> log-mel pipeline (layers/audio.py), clipped or
zero-padded to the target frames. The images are the mels in [0, 1] times
255, truncated to uint8, (N, frames, n_mels, 1): square for the diffusion
configs (image_size 32), [frames, n_mels] rectangles for the VAE configs'
`image_size: [64, 128]`.

The port computes every clip's STFT at once in fp32 with torch.fft, the JAX
package each clip's with XLA's FFT: sums in other orders, so a mel that
lies within rounding of a level boundary can land one level away after
the truncation (tests/test_torch_port_audio.py bounds how many).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from xdiffusion_tpu_torch.datasets.mnist import data_root

CLASS_NAMES = [
    "air conditioner",
    "car horn",
    "children playing",
    "dog bark",
    "drilling",
    "engine idling",
    "gun shot",
    "jackhammer",
    "siren",
    "street music",
]


def synthesize_clips(num_clips: int, sample_rate: int = 22050, duration: float = 1.0,
                     seed: int = 0):
    """Class-dependent tones + noise: (N, T) float32 clips, (N,) int32 labels."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sample_rate * duration)) / sample_rate
    clips = np.zeros((num_clips, t.shape[0]), dtype=np.float32)
    labels = rng.integers(0, 10, size=num_clips).astype(np.int32)
    for i, lab in enumerate(labels):
        f0 = 110.0 * (2 ** (lab / 3.0))  # a base pitch per class
        tone = 0.5 * np.sin(2 * np.pi * f0 * t)
        tone += 0.25 * np.sin(2 * np.pi * 2 * f0 * t + rng.uniform(0, np.pi))
        am = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 8) * t)
        noise = rng.normal(scale=0.05, size=t.shape)
        clips[i] = (tone * am + noise).astype(np.float32)
    return clips, labels


def synthesize_logmels(clips: np.ndarray, n_frames: int, n_mels: int) -> np.ndarray:
    """(N, T) clips -> (N, n_frames, n_mels) fp32 log-mels, their frames
    clipped or zero-padded to n_frames."""
    from xdiffusion_tpu_torch.layers.audio import mel_to_logmel, wav_to_mel

    m = mel_to_logmel(wav_to_mel(torch.from_numpy(clips), n_mels=n_mels)).numpy()
    if m.shape[1] >= n_frames:
        return np.ascontiguousarray(m[:, :n_frames])
    return np.pad(m, ((0, 0), (0, n_frames - m.shape[1]), (0, 0)))


class UrbanSound8k:
    """In-memory mel-spectrogram dataset: uint8 images (N, frames, n_mels,
    1) and int32 labels; items as float32 in [0, 1]."""

    num_classes = 10

    def __init__(self, split: str = "train", image_size=32, num_synthetic: int = 512):
        path = os.path.join(data_root(), "urbansound8k", f"melspec_{split}.npz")
        if os.path.exists(path):
            data = np.load(path)
            mels, labels = data["mels"], data["labels"]
            self.synthetic = False
        else:
            mels, labels = self._synthesize(split, image_size, num_synthetic)
            self.synthetic = True
        self.images = (np.clip(mels, 0, 1) * 255).astype(np.uint8)
        self.labels = labels

    @staticmethod
    def _synthesize(split: str, image_size, n: int):
        if isinstance(image_size, (list, tuple)):
            n_frames, n_mels = int(image_size[0]), int(image_size[1])
        else:
            n_frames = n_mels = int(image_size)
        clips, labels = synthesize_clips(n, seed=0 if split == "train" else 1)
        return synthesize_logmels(clips, n_frames, n_mels)[..., None], labels

    def __len__(self):
        return self.images.shape[0]

    def __getitem__(self, idx):
        return self.images[idx].astype(np.float32) / 255.0, int(self.labels[idx])


def convert_labels_to_prompts(labels: np.ndarray,
                              rng: Optional[np.random.Generator] = None) -> List[str]:
    """The class name of each label; `rng` is taken for the trainers' common
    call and not drawn from (each class has one name)."""
    return [CLASS_NAMES[int(l)] for l in np.asarray(labels).reshape(-1)]
