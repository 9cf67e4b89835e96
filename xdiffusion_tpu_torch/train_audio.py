"""CLI: train an audio (log-mel spectrogram) diffusion model with the port.

    python -m xdiffusion_tpu_torch.train_audio \
        --config_path configs/audio/urbansound8k/ddpm_32x32_v_continuous_clap.yaml \
        --num_training_steps 10000 --batch_size 64

Mirrors the flags of training/audio/urbansound8k/train.py and adds
`--device` (CUDA unless `--device cpu`; `--force_cpu` means the same). The
mels train as images through the image trainer on `audio/urbansound8k`
(its synthetic stand-in without `urbansound8k/melspec_train.npz` under
$XDIFFUSION_DATA_DIR), the labels' class names as prompts;
`--autoencoder_checkpoint` (a run directory or `.pt` of the autoencoder
trainers) gives a latent config its frozen VAE. Writes metrics.jsonl,
sample-<step>.png mel grids and checkpoints/<step>.pt under
<output_path>/audio_urbansound8k/<config name>/.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Train audio diffusion (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--num_training_steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--dataset_name", type=str, default="audio/urbansound8k")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--save_and_sample_every_n", type=int, default=1000)
    p.add_argument("--autoencoder_checkpoint", type=str, default="")
    p.add_argument("--resume_from", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.training.image.train import train

    return train(
        config_path=args.config_path,
        num_training_steps=args.num_training_steps,
        batch_size=args.batch_size,
        dataset_name=args.dataset_name,
        output_path=args.output_path,
        save_and_sample_every_n=args.save_and_sample_every_n,
        resume_from=args.resume_from or None,
        vae_checkpoint=args.autoencoder_checkpoint or None,
        seed=args.seed,
        num_samples=args.num_samples,
        device="cpu" if args.force_cpu else args.device,
    )


if __name__ == "__main__":
    main()
