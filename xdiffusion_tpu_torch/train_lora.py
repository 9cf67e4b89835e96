"""CLI: LoRA fine-tuning of an image diffusion model with the port.

    python -m xdiffusion_tpu_torch.train_lora \
        --config_path configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml \
        --load_model_weights_from_checkpoint output/image_mnist/<run>/checkpoints \
        --num_training_steps 1000 --lora_rank 4

Counterpart of training/image/mnist/train_lora.py: the training CLI
(`xdiffusion_tpu_torch.train`) with `--use_lora_training` forced on;
`--load_model_weights_from_checkpoint` supplies the frozen base. The run
writes <run>/lora_weights.pkl, which the sampling CLI merges with
`--lora_weights`.
"""

from __future__ import annotations

from typing import List, Optional


def main(argv: Optional[List[str]] = None, defaults: Optional[List[str]] = None) -> str:
    """`defaults` are flags given before `argv` (a later flag overrides them)."""
    import sys

    from xdiffusion_tpu_torch import train

    args = list(sys.argv[1:] if argv is None else argv)
    if "--use_lora_training" not in args:
        args.append("--use_lora_training")
    return train.main((defaults or []) + args)


if __name__ == "__main__":
    main()
