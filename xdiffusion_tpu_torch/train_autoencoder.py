"""CLI: train an image VAE with GAN losses with the port.

    python -m xdiffusion_tpu_torch.train_autoencoder \
        --config_path configs/audio/urbansound8k/vae.yaml \
        --num_training_steps 10000 --batch_size 64

Mirrors the flags of training/image/autoencoder.py and adds `--device` (CUDA
unless `--device cpu`; `--force_cpu` means the same). Writes metrics.jsonl,
reconstruction-<step>.png and checkpoints/<step>.pt under
<output_path>/<dataset>/<config name>/.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def parser(description: str, batch_size: int, dataset_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--num_training_steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--dataset_name", type=str, default=dataset_name)
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--save_and_sample_every_n", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=4.5e-6)
    p.add_argument("--resume_from", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return p


def run(train, args) -> str:
    return train(
        config_path=args.config_path,
        num_training_steps=args.num_training_steps,
        batch_size=args.batch_size,
        dataset_name=args.dataset_name,
        output_path=args.output_path,
        save_and_sample_every_n=args.save_and_sample_every_n,
        learning_rate=args.learning_rate,
        resume_from=args.resume_from or None,
        seed=args.seed,
        device="cpu" if args.force_cpu else args.device,
    )


def main(argv: Optional[List[str]] = None) -> str:
    args = parser("Train a VAE autoencoder (PyTorch port).", 64, "image/mnist").parse_args(argv)
    from xdiffusion_tpu_torch.training.image.autoencoder import train_autoencoder

    return run(train_autoencoder, args)


if __name__ == "__main__":
    main()
