"""CLI: LoRA fine-tuning on image-view Moving-MNIST with the port.

    python -m xdiffusion_tpu_torch.train_lora_moving_mnist \
        --config_path configs/image/moving_mnist/<config>.yaml \
        --load_model_weights_from_checkpoint <base run>/checkpoints

Counterpart of training/image/moving_mnist/train_lora.py: `train_lora`
with `--dataset_name image/moving_mnist` unless another is given.
"""

from __future__ import annotations

from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> str:
    from xdiffusion_tpu_torch import train_lora

    return train_lora.main(argv, defaults=["--dataset_name", "image/moving_mnist"])


if __name__ == "__main__":
    main()
