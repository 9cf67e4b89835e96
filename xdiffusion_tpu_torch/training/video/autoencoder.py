"""Video (causal 3-D) VAE-GAN training loop.

Counterpart of xdiffusion_tpu/training/video/autoencoder.py: the image VAE
trainer's two-phase step (training/image/autoencoder.py) over (B, F, H, W,
C) clips of the config's frame count (`input_number_of_frames`, else
`sample_tsize`, else 17) from the video dataset, a strip of inputs over
reconstructions at each save. The Hunyuan and OpenSora decoders give back
fewer frames than they were given when the count is even (the synthetic
Moving-MNIST's 16: 15 and 13), and the loss then fails on the shapes, as
JAX's does.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Union

import numpy as np
import torch

from xdiffusion_tpu_torch.config import load_yaml
from xdiffusion_tpu_torch.datasets import load_dataset
from xdiffusion_tpu_torch.datasets.utils import batch_iterator, prefetch
from xdiffusion_tpu_torch.training.common import MetricsLogger, save_image_grid
from xdiffusion_tpu_torch.training.image.autoencoder import (
    build_vae,
    create_vae_train_state,
    make_vae_train_step,
    restore_vae_checkpoint,
    save_vae_checkpoint,
)


def clip_frames(config) -> int:
    key = "autoencoder" if "autoencoder" in config else "vae_config"
    params = config[key].params
    return int(params.get("input_number_of_frames", params.get("sample_tsize", 17)))


def train_autoencoder(
    config_path: str,
    num_training_steps: int = 10000,
    batch_size: int = 4,
    dataset_name: str = "video/moving_mnist",
    output_path: str = "output",
    save_and_sample_every_n: int = 1000,
    learning_rate: float = 4.5e-6,
    resume_from: Optional[str] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    log_every: int = 50,
) -> str:
    """Trains a video VAE on `device` (CUDA unless "cpu"). Returns the run
    directory with metrics.jsonl (total_loss, kl_loss), recon-<step>.png and
    checkpoints/<step>.pt."""
    config = load_yaml(config_path)
    run_name = os.path.splitext(os.path.basename(config_path))[0]
    out_dir = os.path.join(output_path, dataset_name.replace("/", "_"), run_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    torch.manual_seed(seed)
    vae = build_vae(config, device)
    if vae.disc is None:
        raise ValueError(f"{config_path}: the autoencoder config needs a loss_config block "
                         "to be trainable")
    dataset, _ = load_dataset(dataset_name, config=config, split="train")
    num_frames = clip_frames(config)
    n = sum(p.numel() for p in vae.ae.parameters())
    print(f"video autoencoder parameters: {n / 1e6:.2f}M on {vae.device}", flush=True)

    state = create_vae_train_state(vae, learning_rate, seed + 1)
    start_step = 0
    if resume_from:
        state, start_step = restore_vae_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)
    step_fn = make_vae_train_step(vae)
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed, skip=start_step))
    logger = MetricsLogger(out_dir)
    t0 = time.time()
    for step in range(start_step, num_training_steps):
        videos = torch.from_numpy(next(batches)["videos"][:, :num_frames]).to(vae.device)
        metrics = step_fn(state, {"images": videos})
        if step % log_every == 0 or step == num_training_steps - 1:
            logger.log(step, {k: metrics[k] for k in ("total_loss", "kl_loss", "disc_loss")
                              if k in metrics})
        if (step + 1) % save_and_sample_every_n == 0 or (step + 1) == num_training_steps:
            save_reconstructions(vae, videos[:2], out_dir, step + 1, seed)
            save_vae_checkpoint(ckpt_dir, state, step + 1)
            print(f"checkpoint + reconstructions @ step {step + 1}", flush=True)
    wall = time.time() - t0
    steps = num_training_steps - start_step
    print(f"trained {steps} steps in {wall:.1f}s ({steps / max(wall, 1e-9):.3f} steps/s)",
          flush=True)
    logger.close()
    return out_dir


def save_reconstructions(vae, clips: torch.Tensor, out_dir: str, step: int, seed: int) -> str:
    """A strip of input frames over reconstructed frames a clip (the
    posterior drawn from a generator seeded by seed + 3), as
    <out_dir>/recon-<step>.png."""
    generator = torch.Generator(device=vae.device).manual_seed(seed + 3)
    with torch.no_grad():
        recon = vae.decode_from_latents(vae.encode_to_latents(clips, generator=generator))
    recon = recon[:, :clips.shape[1]].clamp(0, 1).cpu().numpy()
    clips = clips.cpu().numpy()
    strips = [np.concatenate([np.concatenate(list(clips[i]), axis=1),
                              np.concatenate(list(recon[i]), axis=1)], axis=0)
              for i in range(recon.shape[0])]
    path = os.path.join(out_dir, f"recon-{step}.png")
    save_image_grid(np.stack(strips), path, cols=1)
    return path
