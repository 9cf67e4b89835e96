"""CLI: progressive distillation (Salimans & Ho 2022) with the port.

    python -m xdiffusion_tpu_torch.distill \\
        --config_path configs/image/mnist/ddpm_32x32_v_continuous.yaml \\
        --teacher_model_checkpoint <run dir, checkpoints dir or .pt> \\
        --distillation_iterations 4 --initial_sampling_steps 1024

Mirrors the flags of training/image/mnist/distill.py and adds `--device`
(CUDA unless `--device cpu`). The teacher is the checkpoint's parameters,
not its EMA, as the JAX CLI restores `state.params`. Each iteration halves
the step count N: the student starts as a copy of the teacher, with a fresh
optimizer state, learns to match two of the teacher's DDIM steps with one
for `--steps_per_iteration` steps, writes
`<output_path>/checkpoints_N<N>/<step>.pt` and becomes the next teacher.
Each step's timesteps and noise come from a generator seeded by (seed + 1,
step within the iteration), so every iteration repeats the same draws over
other batches, as the JAX CLI's key folded from a step count that starts
again at 0 does. Metrics go to `<output_path>/metrics.jsonl` every 100
steps.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import List, Optional

import numpy as np
import torch


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """A generator seeded by (seed, step)."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description="Progressive distillation (PyTorch port).")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--teacher_model_checkpoint", type=str, required=True)
    p.add_argument("--distillation_iterations", type=int, default=4)
    p.add_argument("--initial_sampling_steps", type=int, default=1024)
    p.add_argument("--steps_per_iteration", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--dataset_name", type=str, default="image/mnist")
    p.add_argument("--output_path", type=str, default="output/distilled")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from xdiffusion_tpu_torch import checkpoints
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.datasets import load_dataset
    from xdiffusion_tpu_torch.datasets.utils import batch_iterator
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import TrainState
    from xdiffusion_tpu_torch.training.common import MetricsLogger

    config = load_yaml(args.config_path)
    torch.manual_seed(args.seed)
    model = GaussianDiffusion_DDPM(config, device=args.device)
    assert model.noise_scheduler().continuous(), (
        "progressive distillation requires a continuous (logSNR) scheduler")
    dataset, _ = load_dataset(args.dataset_name, config=config, split="train")
    batches = batch_iterator(dataset, args.batch_size, seed=args.seed)

    net = model.score_network()
    checkpoints.load_params(args.teacher_model_checkpoint, net)
    teacher_params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    teacher = copy.deepcopy(net).requires_grad_(False).eval()
    os.makedirs(args.output_path, exist_ok=True)
    logger = MetricsLogger(args.output_path)

    n = args.initial_sampling_steps
    for iteration in range(args.distillation_iterations):
        n = max(n // 2, 1)
        print(f"distillation iteration {iteration}: N={n}", flush=True)
        net.load_state_dict(teacher_params)
        teacher.load_state_dict(teacher_params)
        tx = default_optimizer().build(net.parameters())
        for step in range(args.steps_per_iteration):
            images = torch.from_numpy(next(batches)["images"]).to(model.device)
            generator = step_generator(model.device, args.seed + 1, step)
            tx.zero_grad()
            loss, _ = model.distillation_loss_on_batch(images, {}, n, teacher,
                                                       generator=generator)
            loss.backward()
            tx.step()
            if step % 100 == 0:
                logger.log(iteration * args.steps_per_iteration + step,
                           {"loss": loss.detach(), "N": n})
        teacher_params = {k: v.detach().clone() for k, v in net.state_dict().items()}
        state = TrainState(step=args.steps_per_iteration, model=model, optimizer=tx, ema=None,
                           generator=generator)
        checkpoints.save_checkpoint(os.path.join(args.output_path, f"checkpoints_N{n}"), state,
                                    (iteration + 1) * args.steps_per_iteration)
        print(f"saved distilled model @ N={n}", flush=True)
    logger.close()
    return args.output_path


if __name__ == "__main__":
    main()
