"""CLI: train a causal 3-D video VAE with the port.

    python -m xdiffusion_tpu_torch.train_video_autoencoder \
        --config_path configs/video/moving_mnist/ltx_video/autoencoder.yaml \
        --num_training_steps 10000 --batch_size 4

Mirrors the flags of training/video/autoencoder.py and adds `--device`.
Writes metrics.jsonl, recon-<step>.png and checkpoints/<step>.pt under
<output_path>/video_moving_mnist/<config name>/.
"""

from __future__ import annotations

from typing import List, Optional

from xdiffusion_tpu_torch.train_autoencoder import parser, run


def main(argv: Optional[List[str]] = None) -> str:
    args = parser("Train a video autoencoder (PyTorch port).", 4,
                  "video/moving_mnist").parse_args(argv)
    from xdiffusion_tpu_torch.training.video.autoencoder import train_autoencoder

    return run(train_autoencoder, args)


if __name__ == "__main__":
    main()
