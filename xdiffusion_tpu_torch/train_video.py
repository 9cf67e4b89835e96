"""CLI: train a video diffusion model with the port.

    python -m xdiffusion_tpu_torch.train_video \
        --config_path configs/video/moving_mnist/ltx_video/ltx_video_pixel_space.yaml \
        --num_training_steps 10000 --batch_size 8

Mirrors the flags of training/video/train.py and adds `--device` (CUDA
unless `--device cpu`; `--force_cpu` means the same).
Flags of features that are not ported raise. Without Moving-MNIST archives
under $XDIFFUSION_DATA_DIR (default data/) it trains on the synthetic
bouncing digits. Writes metrics.jsonl, sample-<step>.png (a row of frames
per video) and checkpoints/<step>.pt under
<output_path>/video_moving_mnist/<config name>/.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Train a video diffusion model (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--num_training_steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dataset_name", type=str, default="video/moving_mnist")
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--save_and_sample_every_n", type=int, default=1000)
    p.add_argument("--joint_image_video_training_step", type=int, default=-1)
    p.add_argument("--resume_from", type=str, default="")
    p.add_argument("--load_model_weights_from_checkpoint", type=str, default="")
    p.add_argument("--load_vae_weights_from_checkpoint", type=str, default="")
    p.add_argument("--train_temporal_modules_only", action="store_true")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force_cpu", action="store_true")
    p.add_argument("--sampling_steps", type=int, default=0,
                   help="sampling steps of the preview strips (0 = the scheduler's full ladder)")
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch.training.video.train import train

    return train(
        config_path=args.config_path,
        num_training_steps=args.num_training_steps,
        batch_size=args.batch_size,
        dataset_name=args.dataset_name,
        output_path=args.output_path,
        save_and_sample_every_n=args.save_and_sample_every_n,
        joint_image_video_training_step=args.joint_image_video_training_step,
        resume_from=args.resume_from or None,
        load_model_weights_from_checkpoint=args.load_model_weights_from_checkpoint or None,
        load_vae_weights_from_checkpoint=args.load_vae_weights_from_checkpoint or None,
        train_temporal_modules_only=args.train_temporal_modules_only,
        num_samples=args.num_samples,
        sampling_steps=args.sampling_steps,
        seed=args.seed,
        device="cpu" if args.force_cpu else args.device,
    )


if __name__ == "__main__":
    main()
