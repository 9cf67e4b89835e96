"""Audio <-> mel-spectrogram transforms.

Counterpart of xdiffusion_tpu/layers/audio.py in torch, on any device:
`mel_filterbank` (the HTK-scale triangular filterbank, the same numpy
code), `stft_mag` (the centred, Hann-windowed |STFT|), `wav_to_mel` (power
mel-spectrogram (frames, n_mels)), `mel_to_wav` (Griffin-Lim: the
pseudo-inverse filterbank, then phase recovery), and the log-mel
normalisers `mel_to_logmel` and `logmel_to_mel`. Each takes a leading
batch of clips too.

Griffin-Lim's initial phases are uniform draws in [0, 1) times 2 pi: the
JAX package draws them from `jax.random.uniform` of its key; here from an
explicit `torch.Generator`, or they are given (`phases`, the draws
themselves). Its overlap-add runs as `F.fold`, which sums each sample's
frames in frame order on every device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache()
def mel_filterbank(sample_rate: int = 22050, n_fft: int = 1024, n_mels: int = 80,
                   f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular mel filterbank (HTK scale)."""
    f_max = f_max or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sample_rate / 2, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fb = np.zeros((n_mels, n_freqs), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def hann_window(n: int, device=None) -> torch.Tensor:
    """numpy's symmetric Hann window, computed in fp32 as jnp.hanning does."""
    if n <= 1:
        return torch.ones((n,), dtype=torch.float32, device=device)
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 * (1 - torch.cos(2 * math.pi * i / (n - 1)))


def _frame_index(n_frames: int, n_fft: int, hop: int, device) -> torch.Tensor:
    return (torch.arange(n_frames, device=device)[:, None] * hop
            + torch.arange(n_fft, device=device)[None, :])


def stft_mag(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT| of (..., T) clips -> (..., frames, n_fft // 2 + 1): a Hann
    window, centred (reflect-padded by n_fft // 2)."""
    pad = n_fft // 2
    lead = wav.shape[:-1]
    wav = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (wav.shape[-1] - n_fft) // hop
    frames = wav[:, _frame_index(n_frames, n_fft, hop, wav.device)] * hann_window(n_fft,
                                                                                  wav.device)
    spec = torch.fft.rfft(frames, dim=-1).abs()
    return spec.reshape(*lead, n_frames, n_fft // 2 + 1)


def wav_to_mel(wav, sample_rate: int = 22050, n_fft: int = 1024, hop_length: int = 256,
               n_mels: int = 80) -> torch.Tensor:
    """(..., T) waveforms -> (..., frames, n_mels) power mel-spectrograms, fp32."""
    wav = torch.as_tensor(wav, dtype=torch.float32)
    mag = stft_mag(wav, n_fft, hop_length)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(wav.device)
    return (mag ** 2) @ fb.T


def mel_to_wav(mel: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
               hop_length: int = 256, n_mels: int = 80, n_iter: int = 32,
               generator: Optional[torch.Generator] = None,
               phases: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim: (..., frames, n_mels) power mels -> (..., frames *
    hop_length) waveforms. `phases` (the mel's leading shape, frames,
    n_fft // 2 + 1), uniform in [0, 1), start the recovery at angles 2 pi
    phases; else they are drawn from `generator` (on the mel's device)."""
    mel = torch.as_tensor(mel, dtype=torch.float32)
    fb = mel_filterbank(sample_rate, n_fft, n_mels)
    pinv = torch.from_numpy(np.linalg.pinv(fb).astype(np.float32)).to(mel.device)
    lead = mel.shape[:-2]
    mel = mel.reshape(-1, *mel.shape[-2:])
    mag = torch.sqrt((mel @ pinv.T).clamp_min(0.0))  # (N, frames, n_freqs)
    n, n_frames, n_freqs = mag.shape
    length = n_frames * hop_length
    window = hann_window(n_fft, mel.device)
    idx = _frame_index(n_frames, n_fft, hop_length, mel.device)

    span = (n_frames - 1) * hop_length + n_fft

    def overlap_add(frames):  # (N, n_frames, n_fft) -> (N, length + n_fft)
        out = F.fold(frames.transpose(1, 2), output_size=(1, span), kernel_size=(1, n_fft),
                     stride=(1, hop_length))[:, 0, 0]
        return F.pad(out, (0, length + n_fft - span))

    norm = overlap_add((window ** 2).expand(1, n_frames, n_fft)).clamp_min(1e-8)

    def istft(spec):
        return overlap_add(torch.fft.irfft(spec, n=n_fft, dim=-1) * window) / norm

    def stft(wav):  # not centred: frames from sample 0, zero-padded at the end
        w = F.pad(wav[:, :length], (0, max(0, length - wav.shape[1]) + n_fft))
        return torch.fft.rfft(w[:, idx] * window, dim=-1)

    if phases is None:
        phases = torch.rand((n, n_frames, n_freqs), generator=generator, device=mel.device)
    angles = torch.exp(2j * math.pi * phases.reshape(n, n_frames, n_freqs).to(torch.float32))
    for _ in range(n_iter):
        spec = stft(istft(mag * angles))
        angles = spec / spec.abs().clamp_min(1e-8)
    wav = istft(mag * angles)[:, :length]
    return wav.reshape(*lead, length)


def _log_eps(eps: float) -> torch.Tensor:
    # The fp32 log of fp32 eps, as jnp.log(eps) computes it.
    return torch.log(torch.tensor(eps, dtype=torch.float32))


def mel_to_logmel(mel: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Power mel -> the log scale (log(max(mel, eps)) - log eps) / (-2 log eps)."""
    log_eps = _log_eps(eps).to(mel.device)
    return (torch.log(mel.clamp_min(eps)) - log_eps) / (-2.0 * log_eps)


def logmel_to_mel(logmel: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    log_eps = _log_eps(eps).to(logmel.device)
    return torch.exp(logmel * (-2.0 * log_eps) + log_eps)
