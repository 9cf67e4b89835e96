"""CLI: train an image diffusion model with the port.

    python -m xdiffusion_tpu_torch.train \
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \
        --num_training_steps 10000 --batch_size 128

Mirrors the flags of training/image/train.py and adds `--device` (CUDA
unless `--device cpu`; `--force_cpu` means the same). `--use_lora_training`
(with `--lora_rank`) fine-tunes LoRA factors over the frozen base that
`--load_model_weights_from_checkpoint` names; `--gradient_accumulation_steps
k` averages k mini-batches a update; `--profile_start_step s` traces steps
s to s + 2 into <run>/profile; `--debug_nans` raises FloatingPointError at
the module that makes a NaN. Without MNIST's IDX files under
$XDIFFUSION_DATA_DIR (default data/) it trains on the synthetic digits.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Train an image diffusion model (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--num_training_steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--save_and_sample_every_n", type=int, default=1000)
    p.add_argument("--sample_with_guidance", action="store_true")
    p.add_argument("--resume_from", type=str, default="")
    p.add_argument("--load_model_weights_from_checkpoint", type=str, default="")
    p.add_argument("--mixed_precision", type=str, default="")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--profile_start_step", type=int, default=-1)
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--use_lora_training", action="store_true")
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
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
        sample_with_guidance=args.sample_with_guidance,
        resume_from=args.resume_from or None,
        load_model_weights_from_checkpoint=args.load_model_weights_from_checkpoint or None,
        mixed_precision=args.mixed_precision,
        num_samples=args.num_samples,
        seed=args.seed,
        profile_start_step=args.profile_start_step,
        debug_nans=args.debug_nans,
        use_lora_training=args.use_lora_training,
        lora_rank=args.lora_rank,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        device="cpu" if args.force_cpu else args.device,
    )


if __name__ == "__main__":
    main()
