"""CLI: sample an audio-diffusion checkpoint with the port and write WAV files.

    python -m xdiffusion_tpu_torch.sample_audio \
        --config_path configs/audio/urbansound8k/ddpm_32x32_v_continuous_clap.yaml \
        --checkpoint output/audio_urbansound8k/<run>/checkpoints/<step>.pt

Counterpart of tools/sample_audio.py: loads a checkpoint (a training
checkpoint's EMA parameters when it tracks them, else its parameters; a
port `state_dict`; or flattened flax parameters, `.npz`), samples
`--num_samples` log-mel spectrograms with the config's sampler, prompted
by the UrbanSound8k class names in turn, inverts each (log-mel -> power
mel -> pseudo-inverse filterbank -> 24 Griffin-Lim iterations,
layers/audio.py) and writes `sample-<i>-<class>.wav` (16-bit PCM, peak
normalised, 22,050 Hz) and `mel_grid.png` under `--output_path`, then
prints one JSON line with the sampling throughput. Sampling and
Griffin-Lim run on the device (CUDA unless `--device cpu`); Griffin-Lim's
phases come from a generator seeded by `--seed`. The JAX tool inverts on
the host's CPU backend with phases from PRNGKey(0).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import wave
from typing import List, Optional

import numpy as np
import torch


def write_wav(path: str, wav, sample_rate: int = 22050) -> None:
    wav = np.asarray(wav, dtype=np.float32)
    peak = float(np.max(np.abs(wav))) or 1.0
    pcm = (np.clip(wav / peak, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="Sample audio and write WAVs (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--sampling_steps", type=int, default=0)
    p.add_argument("--output_path", type=str, default="output/audio_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets.urbansound8k import CLASS_NAMES
    from xdiffusion_tpu_torch.layers.audio import logmel_to_mel, mel_to_wav
    from xdiffusion_tpu_torch.training.common import save_image_grid
    from xdiffusion_tpu_torch.training.image.train import build_model
    from xdiffusion_tpu_torch.weights import load_checkpoint

    model = build_model(load_yaml(args.config_path), device=args.device)
    step = load_checkpoint(model.score_network(), args.checkpoint)
    print(f"restored step {step}", flush=True)

    prompts = [CLASS_NAMES[i % len(CLASS_NAMES)] for i in range(args.num_samples)]
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    mels = model.sample(num_samples=args.num_samples, context={"text_prompts": prompts},
                        num_sampling_steps=args.sampling_steps or None, generator=generator)
    mels = mels.float()  # (N, frames, n_mels, 1) in [0, 1]
    host = mels.cpu().numpy()  # waits for the device
    dt = time.perf_counter() - t0

    os.makedirs(args.output_path, exist_ok=True)
    save_image_grid(host, os.path.join(args.output_path, "mel_grid.png"))
    # (frames, n_mels) log-mel in [0, 1] -> power mel -> waveform.
    wavs = mel_to_wav(logmel_to_mel(mels[..., 0]), n_mels=mels.shape[2], n_iter=24,
                      generator=generator).cpu().numpy()
    for i, (wav, prompt) in enumerate(zip(wavs, prompts)):
        write_wav(os.path.join(args.output_path,
                               f"sample-{i}-{prompt.replace(' ', '_')}.wav"), wav)
    result = {"num_samples": args.num_samples,
              "samples_per_sec": round(args.num_samples / dt, 3),
              "checkpoint_step": int(step), "output_path": args.output_path}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
