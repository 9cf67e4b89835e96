"""CLI: build a mel-spectrogram dataset from audio clips.

    python -m xdiffusion_tpu_torch.create_mel_spec [--audio_dir <dir>] \\
        [--num_clips 2048] [--image_size 32] [--split train]

Counterpart of tools/create_mel_spec.py (reference tool surface:
tools/create_mel_spec.py:23), with its flags. Reads .wav files from
--audio_dir (a folder per class, named after `CLASS_NAMES` with spaces as
underscores) when present; otherwise synthesizes the class-coloured clips
(datasets/urbansound8k.py `synthesize_clips`). Each clip becomes a log-mel
of `--image_size` frames and mels (layers/audio.py `wav_to_mel`,
`mel_to_logmel`; cut or zero-padded in time). Writes
{data_root}/urbansound8k/melspec_{split}.npz (`mels` float32 (N, S, S, 1),
`labels` int32), which the audio/urbansound8k dataset reads; the data root
is the port's (datasets/mnist.py `data_root`). The spectrograms are
computed on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import wave
from typing import List, Optional

import numpy as np
import torch


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        data = w.readframes(w.getnframes())
        arr = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            arr = arr.reshape(-1, w.getnchannels()).mean(axis=1)
        return arr


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Create mel-spec dataset (PyTorch port).")
    p.add_argument("--audio_dir", type=str, default="")
    p.add_argument("--num_clips", type=int, default=2048)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.datasets.mnist import data_root
    from xdiffusion_tpu_torch.datasets.urbansound8k import CLASS_NAMES, synthesize_clips
    from xdiffusion_tpu_torch.layers.audio import mel_to_logmel, wav_to_mel
    from xdiffusion_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)

    clips, labels = [], []
    if args.audio_dir and os.path.isdir(args.audio_dir):
        for li, name in enumerate(CLASS_NAMES):
            cdir = os.path.join(args.audio_dir, name.replace(" ", "_"))
            if not os.path.isdir(cdir):
                continue
            for f in sorted(os.listdir(cdir)):
                if f.endswith(".wav"):
                    clips.append(read_wav(os.path.join(cdir, f)))
                    labels.append(li)
    if not clips:
        arr, labels = synthesize_clips(args.num_clips, seed=args.seed)
        clips = list(arr)

    mels = []
    for clip in clips:
        wav = torch.from_numpy(np.asarray(clip, dtype=np.float32)).to(device)
        m = mel_to_logmel(wav_to_mel(wav, n_mels=args.image_size)).cpu().numpy()
        frames = m.shape[0]
        if frames >= args.image_size:
            m = m[: args.image_size]
        else:
            m = np.pad(m, ((0, args.image_size - frames), (0, 0)))
        mels.append(m)
    mels = np.stack(mels)[..., None].astype(np.float32)
    labels = np.asarray(labels, dtype=np.int32)

    out_dir = os.path.join(data_root(), "urbansound8k")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"melspec_{args.split}.npz")
    np.savez_compressed(out, mels=mels, labels=labels)
    print(f"wrote {out}: mels {mels.shape}", flush=True)
    return out


if __name__ == "__main__":
    main()
