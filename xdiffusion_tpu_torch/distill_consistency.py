"""CLI: consistency distillation (or consistency training) with the port.

    python -m xdiffusion_tpu_torch.distill_consistency \\
        --teacher_config_path configs/image/mnist/edm.yaml \\
        --student_config_path configs/image/mnist/consistency_model_distillation.yaml \\
        --teacher_checkpoint <run dir, checkpoints dir or .pt>

Mirrors the flags of training/image/mnist/distill_consistency.py and adds
`--device` (CUDA unless `--device cpu`). The teacher is the checkpoint's
parameters, not its EMA, as the JAX CLI restores `t_state.params`; its
network runs frozen under no_grad. Each step takes (target EMA rate, N)
from the student's schedule, updates the score network with the default
Adam, then moves the target network by the schedule's rate and the
sampling EMA by 0.9999. A consistency-training config
(consistency_model.yaml) runs the same loop, its loss ignoring the
teacher. Every 1000 steps and at the end it writes
`<output_path>/sample-<step>.png` (16 samples of the student's sampler) and
`<output_path>/checkpoints/<step>.pt` (the score, target and EMA
networks); metrics go to `<output_path>/metrics.jsonl` every 100 steps.
Each step's draws come from a generator seeded by (seed + 1, step).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch


def save_consistency_checkpoint(directory: str, student, optimizer, step: int) -> str:
    """`<directory>/<step>.pt`: the step, the score network's parameters
    under "params", the target's under "target", the EMA's under "ema" (or
    None) and the optimizer state; `weights.load_checkpoint` takes the EMA
    from it, else the score network, as the JAX package's `sample` does."""
    os.makedirs(directory, exist_ok=True)
    nets = student.networks()
    payload = {"step": int(step), "params": nets["score"].state_dict(),
               "target": nets["target"].state_dict(),
               "ema": nets["ema"].state_dict() if "ema" in nets else None,
               "optimizer": optimizer.state_dict()}
    path = os.path.join(directory, f"{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Consistency distillation (PyTorch port).")
    p.add_argument("--teacher_config_path", type=str, required=True)
    p.add_argument("--student_config_path", type=str, required=True)
    p.add_argument("--teacher_checkpoint", type=str, required=True)
    p.add_argument("--num_training_steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--output_path", type=str, default="output/consistency_distilled")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator
    from xdiffusion_tpu_torch.diffusion.consistency import GaussianDiffusion_ConsistencyModel
    from xdiffusion_tpu_torch.distill import step_generator
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.training.common import MetricsLogger, save_image_grid
    from xdiffusion_tpu_torch.training.image.train import build_model

    torch.manual_seed(args.seed)
    teacher_model = build_model(load_yaml(args.teacher_config_path), device=args.device)
    student = GaussianDiffusion_ConsistencyModel(load_yaml(args.student_config_path),
                                                 device=args.device)
    device = student.device
    dataset, _ = load_dataset(args.dataset_name, config=student.config(), split="train")
    batches = batch_iterator(dataset, args.batch_size, seed=args.seed)

    teacher_net = teacher_model.score_network()
    checkpoints.load_params(args.teacher_checkpoint, teacher_net)
    teacher_net.requires_grad_(False).eval()

    def teacher_denoise(x, sigma):
        return teacher_net(x, sigma)

    tx = default_optimizer().build(student.score_network().parameters())
    scale_fn = student.scale_fn(args.num_training_steps)
    os.makedirs(args.output_path, exist_ok=True)
    logger = MetricsLogger(args.output_path)
    for step in range(args.num_training_steps):
        target_ema, num_scales = scale_fn(step)
        images = torch.from_numpy(next(batches)["images"]).to(device)
        tx.zero_grad()
        loss, _ = student.loss_on_batch(images, {"num_scales": num_scales},
                                        teacher_denoise_fn=teacher_denoise,
                                        generator=step_generator(device, args.seed + 1, step))
        loss.backward()
        tx.step()
        student.update_auxiliary_params(target_ema, ema_rate=0.9999)
        if step % 100 == 0:
            logger.log(step, {"loss": loss.detach(), "num_scales": num_scales})
        if (step + 1) % 1000 == 0 or step + 1 == args.num_training_steps:
            samples = student.sample(num_samples=16,
                                     generator=torch.Generator(device=device).manual_seed(step))
            save_image_grid(samples.float().cpu().numpy(),
                            os.path.join(args.output_path, f"sample-{step + 1}.png"))
            save_consistency_checkpoint(os.path.join(args.output_path, "checkpoints"), student,
                                        tx, step + 1)
    logger.close()
    return args.output_path


if __name__ == "__main__":
    main()
