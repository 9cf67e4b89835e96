"""Image-diffusion training loop.

Counterpart of xdiffusion_tpu/training/image/train.py on the branches the
flagship config takes, on one device: config batch precedence, the dataset
(real MNIST if present, else the synthetic digits), the optimizer and the
EMA from the config, resume or weight loading, the loop, metrics every
`log_every` steps, and a sample grid plus a checkpoint every
`save_and_sample_every_n` steps and at the end. Meshes, LoRA, latent
diffusion, gradient accumulation, the profiler and NaN debugging raise
`NotImplementedError`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import torch

from xdiffusion_tpu_torch import checkpoints
from xdiffusion_tpu_torch.config import DotConfig, instantiate_from_config, load_yaml
from xdiffusion_tpu_torch.datasets import load_dataset
from xdiffusion_tpu_torch.datasets.utils import batch_iterator, prefetch
from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
from xdiffusion_tpu_torch.importance_sampling import UniformSampler
from xdiffusion_tpu_torch.optim import GradientTransform, default_optimizer
from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
from xdiffusion_tpu_torch.training.common import MetricsLogger, save_image_grid


def build_model(config: DotConfig, device=None) -> GaussianDiffusion_DDPM:
    if "diffusion_cascade" in config or "target" in config:
        raise NotImplementedError("cascades and custom process targets are not ported yet")
    return GaussianDiffusion_DDPM(config, device=device)


def build_optimizer(config: DotConfig, params) -> GradientTransform:
    opt = (instantiate_from_config(config.optimizer.to_dict())
           if "optimizer" in config else default_optimizer())
    schedule = None
    if "learning_rate_schedule" in config:
        schedule = instantiate_from_config(config.learning_rate_schedule.to_dict())
    return opt.build(params, schedule)


def _unported(**flags) -> None:
    for name, active in flags.items():
        if active:
            raise NotImplementedError(f"train: {name} is not ported yet")


def train(
    config_path: str,
    num_training_steps: int = 10000,
    batch_size: int = 128,
    dataset_name: str = "image/mnist",
    output_path: str = "output",
    save_and_sample_every_n: int = 1000,
    sample_with_guidance: bool = False,
    resume_from: Optional[str] = None,
    load_model_weights_from_checkpoint: Optional[str] = None,
    vae_checkpoint: Optional[str] = None,
    seed: int = 0,
    mixed_precision: str = "",
    num_samples: int = 64,
    profile_start_step: int = -1,
    debug_nans: bool = False,
    use_lora_training: bool = False,
    lora_rank: int = 4,
    gradient_accumulation_steps: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    log_every: int = 50,
) -> str:
    """Trains an image diffusion model from a YAML config on `device` (CUDA
    unless "cpu" is asked for). Returns the run's output directory, which
    holds metrics.jsonl, sample-<step>.png grids and checkpoints/<step>.pt.

    A resumed run restores the parameters, optimizer, EMA and generator and
    skips the batches the interrupted run consumed, so it continues the
    uninterrupted run's stream."""
    _unported(vae_checkpoint=vae_checkpoint, mixed_precision=mixed_precision,
              profile_start_step=profile_start_step >= 0, debug_nans=debug_nans,
              use_lora_training=use_lora_training,
              gradient_accumulation_steps=gradient_accumulation_steps > 1)
    config = load_yaml(config_path)
    if "training" in config and "batch_size" in config.training:
        # Config batch size takes precedence unless the CLI overrides it.
        if batch_size <= 0:
            batch_size = config.training.batch_size

    run_name = os.path.splitext(os.path.basename(config_path))[0]
    out_dir = os.path.join(output_path, dataset_name.replace("/", "_"), run_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    torch.manual_seed(seed)  # the modules' initialisers draw from it
    model = build_model(config, device=device)
    net = model.score_network()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"score network parameters: {n_params / 1e6:.2f}M on {model.device}", flush=True)
    if "sampling" in config and "prompt_encoder" in config.sampling:
        raise NotImplementedError("sampling prompt encoders are not ported yet")
    if any(type(p).__name__ != "IgnoreContextAdapter" for p in model._context_preprocessors):
        raise NotImplementedError("prompt-conditioned training is not ported yet")
    if not isinstance(model.importance_sampler(), UniformSampler):
        raise NotImplementedError("host-side importance samplers are not ported yet")

    dataset, _ = load_dataset(dataset_name, config=config, split="train")
    if getattr(dataset, "synthetic", False):
        print("=" * 70 + f"\nWARNING: {dataset_name} archives not found - training on "
              "the SYNTHETIC stand-in dataset. Quality metrics from this run are not "
              "comparable to real-data numbers.\n" + "=" * 70, flush=True)

    tx = build_optimizer(config, net.parameters())
    ema_cfg = config.get("training")
    use_ema = bool(ema_cfg and ema_cfg.get("ema_decay"))
    state = create_train_state(model, tx, ema=use_ema, seed=seed + 1)

    start_step = 0
    if resume_from:
        state, start_step = checkpoints.restore_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)
    elif load_model_weights_from_checkpoint:
        checkpoints.load_params(load_model_weights_from_checkpoint, net)

    ema_decay = float(ema_cfg.get("ema_decay")) if use_ema else None
    train_step = make_train_step(model, ema_decay=ema_decay)
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed, skip=start_step))

    logger = MetricsLogger(out_dir)
    t_start = time.time()
    for step in range(start_step, num_training_steps):
        batch = next(batches)
        device_batch = {"images": torch.from_numpy(batch["images"]).to(model.device)}
        metrics = train_step(state, device_batch)

        if step % log_every == 0 or step == num_training_steps - 1:
            logger.log(step, {k: metrics[k] for k in
                              ("loss", "mse_loss", "vb_loss", "grad_norm")})

        if (step + 1) % save_and_sample_every_n == 0 or (step + 1) == num_training_steps:
            # Guidance needs class or text conditioning, which the ported
            # (unconditional) networks do not take: as in the JAX package, an
            # unconditional model samples without it.
            sample_and_save(model, state, out_dir, step + 1, num_samples=num_samples)
            checkpoints.save_checkpoint(ckpt_dir, state, step + 1)
            print(f"checkpoint + samples saved @ step {step + 1}", flush=True)

    wall = time.time() - t_start
    steps_done = num_training_steps - start_step
    print(f"trained {steps_done} steps in {wall:.1f}s "
          f"({steps_done / max(wall, 1e-9):.2f} steps/s)", flush=True)
    logger.close()
    return out_dir


@contextlib.contextmanager
def _sampling_params(model, state):
    """Samples from the EMA parameters when the state tracks them."""
    if state.ema is None:
        yield
        return
    net = model.score_network()
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    net.load_state_dict(state.ema.state_dict())
    try:
        yield
    finally:
        net.load_state_dict(saved)


def sample_and_save(model, state, out_dir: str, step: int, num_samples: int = 64) -> str:
    """Samples with the config's sampler (from the EMA parameters when
    present) and writes <out_dir>/sample-<step>.png; returns its path."""
    generator = torch.Generator(device=model.device).manual_seed(step)
    with _sampling_params(model, state):
        samples = model.sample(num_samples=num_samples, generator=generator)
    path = os.path.join(out_dir, f"sample-{step}.png")
    save_image_grid(samples.float().cpu().numpy(), path)
    return path
