"""Video-diffusion training loop.

Counterpart of xdiffusion_tpu/training/video/train.py on one device: the
config's optimizer (no EMA, as there), the dataset, prompts from its
labels, the context preprocessors (the text embedder) on the host with only
tensors moved to the device, the frame-mask generator of the config, joint
image/video steps, metrics every `log_every` steps, and a frame-strip PNG
plus a checkpoint every `save_and_sample_every_n` steps and at the end.

Host randomness differs from the JAX package in its seeding only: there the
crop start and masks come from one generator seeded once per run, and the
prompts' surface forms ("3" or "three") from an unseeded one. Here all
three come from a generator seeded by (seed, step), drawn in the same order
and from the same distributions, so a resumed run repeats the
uninterrupted one.

Not ported, and refused with `NotImplementedError`: latent video diffusion
(`load_vae_weights_from_checkpoint` and configs with a latent encoder), the
partial restore of `load_model_weights_from_checkpoint` and
`train_temporal_modules_only`, the Flexible-Diffusion-Modeling batches, and
device meshes (`XDIFFUSION_MESH`). The startup model summary and the
animated GIF are left out.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from xdiffusion_tpu_torch import checkpoints, masking
from xdiffusion_tpu_torch.config import load_yaml
from xdiffusion_tpu_torch.datasets import load_dataset
from xdiffusion_tpu_torch.datasets.utils import batch_iterator, prefetch
from xdiffusion_tpu_torch.sample_video import save_video_strip
from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
from xdiffusion_tpu_torch.training.common import MetricsLogger, is_text_conditional
from xdiffusion_tpu_torch.training.image.train import _unported, build_model, build_optimizer
from xdiffusion_tpu_torch.training_utils import get_training_batch, preprocess_training_videos


def make_mask_generator(config) -> masking.MaskGenerator:
    if "training" in config and "mask_ratios" in config.training:
        return masking.OpenSoraMaskGenerator(mask_ratios=config.training.mask_ratios.to_dict())
    return masking.IdentityMaskGenerator()


def _to(device, array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def train(
    config_path: str,
    num_training_steps: int = 10000,
    batch_size: int = 8,
    dataset_name: str = "video/moving_mnist",
    output_path: str = "output",
    save_and_sample_every_n: int = 1000,
    joint_image_video_training_step: int = -1,
    resume_from: Optional[str] = None,
    load_model_weights_from_checkpoint: Optional[str] = None,
    load_vae_weights_from_checkpoint: Optional[str] = None,
    train_temporal_modules_only: bool = False,
    seed: int = 0,
    num_samples: int = 4,
    sampling_steps: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    log_every: int = 50,
) -> str:
    """Trains a video diffusion model from a YAML config on `device` (CUDA
    unless "cpu" is asked for). Returns the run's output directory, which
    holds metrics.jsonl, sample-<step>.png strips and checkpoints/<step>.pt.

    A resumed run restores the parameters, optimizer and generator and skips
    the batches the interrupted run consumed, so it continues the
    uninterrupted run's stream. `sampling_steps` (0: the scheduler's full
    ladder) sets the steps of the sample strips."""
    _unported(load_model_weights_from_checkpoint=bool(load_model_weights_from_checkpoint),
              load_vae_weights_from_checkpoint=bool(load_vae_weights_from_checkpoint),
              train_temporal_modules_only=train_temporal_modules_only,
              XDIFFUSION_MESH=bool(os.environ.get("XDIFFUSION_MESH")))
    config = load_yaml(config_path)
    if "training" in config and config.training.get("flexible_diffusion_modeling", False):
        raise NotImplementedError("train: Flexible-Diffusion-Modeling batches are not "
                                  "ported yet")
    run_name = os.path.splitext(os.path.basename(config_path))[0]
    out_dir = os.path.join(output_path, dataset_name.replace("/", "_"), run_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    torch.manual_seed(seed)  # the modules' initialisers draw from it
    model = build_model(config, device=device)
    net = model.score_network()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"score network parameters: {n_params / 1e6:.2f}M on {model.device}", flush=True)

    dataset, convert_labels_to_prompts = load_dataset(dataset_name, config=config,
                                                      split="train")
    if getattr(dataset, "synthetic", False):
        print("=" * 70 + f"\nWARNING: {dataset_name} archives not found - training on "
              "the SYNTHETIC stand-in dataset. Quality metrics from this run are not "
              "comparable to real-data numbers.\n" + "=" * 70, flush=True)
    mask_generator = make_mask_generator(model.config())

    tx = build_optimizer(config, net.parameters())
    state = create_train_state(model, tx, seed=seed + 1)
    start_step = 0
    if resume_from:
        state, start_step = checkpoints.restore_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)

    train_step = make_train_step(model)
    needs_text = is_text_conditional(model)
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed, skip=start_step))
    logger = MetricsLogger(out_dir)
    t_start = time.time()
    for step in range(start_step, num_training_steps):
        batch = next(batches)
        rng = np.random.default_rng((seed, step))  # crop start, masks, prompts
        is_image_batch = (joint_image_video_training_step == 1 or (
            joint_image_video_training_step > 1
            and step % joint_image_video_training_step == 0))
        videos = get_training_batch(batch["videos"], is_image_batch, rng=rng)
        videos, extra = preprocess_training_videos(
            videos, model.config(), mask_generator=None if is_image_batch else mask_generator,
            rng=rng)

        device_batch: Dict = {"images": _to(model.device, videos),
                              "frame_indices": _to(model.device, extra["frame_indices"])}
        if extra.get("video_mask") is not None:
            device_batch["video_mask"] = _to(model.device, extra["video_mask"])
        if needs_text:
            # Label -> prompt -> embeddings on the host; only tensors move.
            ctx = model.preprocess_context(
                {"text_prompts": convert_labels_to_prompts(batch["classes"], rng=rng)})
            device_batch.update({k: v.to(model.device) for k, v in ctx.items()
                                 if isinstance(v, torch.Tensor)})
        metrics = train_step(state, device_batch)

        if step % log_every == 0 or step == num_training_steps - 1:
            logger.log(step, {"loss": metrics["loss"], "mse_loss": metrics["mse_loss"],
                              "grad_norm": metrics["grad_norm"],
                              "image_batch": float(is_image_batch)})

        if (step + 1) % save_and_sample_every_n == 0 or (step + 1) == num_training_steps:
            sample_and_save_video(model, out_dir, step + 1, num_samples,
                                  sampling_steps=sampling_steps)
            checkpoints.save_checkpoint(ckpt_dir, state, step + 1)
            print(f"checkpoint + samples saved @ step {step + 1}", flush=True)

    wall = time.time() - t_start
    steps_done = num_training_steps - start_step
    print(f"trained {steps_done} steps in {wall:.1f}s "
          f"({steps_done / max(wall, 1e-9):.2f} steps/s)", flush=True)
    logger.close()
    return out_dir


def sample_and_save_video(model, out_dir: str, step: int, num_samples: int = 4,
                          sampling_steps: int = 0) -> str:
    """Samples `num_samples` videos (prompts "0", "1", ... for a
    text-conditional model) with `sampling_steps` steps (0: the scheduler's
    full ladder) and writes <out_dir>/sample-<step>.png, a row of frames per
    video; returns its path."""
    context = {}
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(num_samples)]
    generator = torch.Generator(device=model.device).manual_seed(step)
    samples = model.sample(num_samples=num_samples, context=context,
                           num_sampling_steps=sampling_steps or None, generator=generator)
    path = os.path.join(out_dir, f"sample-{step}.png")
    save_video_strip(samples.float().cpu().numpy(), path)
    return path
