"""Video-diffusion training loop.

Counterpart of xdiffusion_tpu/training/video/train.py on one device: the
config's optimizer (no EMA, as there), the dataset, prompts from its
labels, the context preprocessors (the text embedder) on the host with only
tensors moved to the device, the frame-mask generator of the config, joint
image/video steps, Flexible Diffusion Modeling's batches (random latent and
observed frame subsets with their source frame indices, for configs with
`training.flexible_diffusion_modeling`), metrics every `log_every` steps,
and a frame-strip PNG, an animated GIF and a checkpoint every
`save_and_sample_every_n` steps and at the end.

The image-to-video warm start: `load_model_weights_from_checkpoint` fills
every parameter of a port checkpoint (an image network's) of the same name
and shape, and leaves the others, which must be temporal modules', at init
(checkpoints.py `restore_params_partial`); `train_temporal_modules_only`
then trains those alone. The frozen parameters take no gradient and stay
out of the optimizer, so they stay bit for bit, and the optimizer and its
clipping norm see only the trained ones, as JAX's `optax.multi_transform`
with `set_to_zero` has it.

Host randomness differs from the JAX package in its seeding only: there the
crop start and masks come from one generator seeded once per run, and the
prompts' surface forms ("3" or "three") from an unseeded one. Here all
three, and the FDM batches, come from a generator seeded by (seed, step),
drawn in the same order and from the same distributions, so a resumed run
repeats the uninterrupted one.

A cascade's batches are prepared by its first stage's config, as in JAX;
its loss then refuses the 5-D batch as JAX's does (diffusion/cascade.py).
Resuming a temporal-only run is refused: the JAX trainer skips the partial
restore on a resume and so freezes every parameter.

Latent video diffusion (`load_vae_weights_from_checkpoint`, a VAE run of the
video autoencoder trainer): the frozen VAE's weights load from it, and the
latent scale comes from the first batch of the stream, which training then
skips, as in JAX; a resume recomputes the same scale from the same batch.
Unlike JAX, whose batches take the score network's latent shape (3 frames
of 4x4 pixels for ltx_video.yaml, which its VAE encodes to a 1x1 latent
grid), a latent process's videos keep the data block's frame count and size,
the VAE's input (17 frames of 32x32: a 3x4x4 grid of 48 tokens, the shape it
samples).

Not ported, and refused with `NotImplementedError`: device meshes
(`XDIFFUSION_MESH`). The start-up model summary (summary.py) prints as in
the JAX trainer unless XDIFFUSION_MODEL_SUMMARY=0.
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
from xdiffusion_tpu_torch.sample_video import save_gif, save_video_strip
from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
from xdiffusion_tpu_torch.training.common import MetricsLogger, is_text_conditional
from xdiffusion_tpu_torch.summary import print_model_summary
from xdiffusion_tpu_torch.training.image.train import (
    build_model,
    build_optimizer,
    prepare_latent_encoder,
)
from xdiffusion_tpu_torch.training_utils import (
    get_training_batch,
    preprocess_training_videos,
    sample_fdm_training_batch,
)


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
    if os.environ.get("XDIFFUSION_MESH"):
        raise NotImplementedError("train: XDIFFUSION_MESH is not ported yet")
    if train_temporal_modules_only and not load_model_weights_from_checkpoint:
        raise ValueError("train_temporal_modules_only needs load_model_weights_from_checkpoint")
    if train_temporal_modules_only and resume_from:
        raise NotImplementedError("train: resuming a temporal-only run (the JAX trainer "
                                  "skips the partial restore on a resume and freezes every "
                                  "parameter)")
    config = load_yaml(config_path)
    use_fdm = bool("training" in config
                   and config.training.get("flexible_diffusion_modeling", False))
    fdm_method = (config.training.get("flexible_diffusion_modeling_method", "random")
                  if use_fdm else None)
    run_name = os.path.splitext(os.path.basename(config_path))[0]
    out_dir = os.path.join(output_path, dataset_name.replace("/", "_"), run_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    torch.manual_seed(seed)  # the modules' initialisers draw from it
    model = build_model(config, device=device)
    print_model_summary(model)
    net = model.score_network()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"score network parameters: {n_params / 1e6:.2f}M on {model.device}", flush=True)

    dataset, convert_labels_to_prompts = load_dataset(dataset_name, config=config,
                                                      split="train")
    if getattr(dataset, "synthetic", False):
        print("=" * 70 + f"\nWARNING: {dataset_name} archives not found - training on "
              "the SYNTHETIC stand-in dataset. Quality metrics from this run are not "
              "comparable to real-data numbers.\n" + "=" * 70, flush=True)
    first = model.models()[0] if hasattr(model, "models") else model
    mask_generator = make_mask_generator(first.config())

    trained = list(net.parameters())
    if load_model_weights_from_checkpoint and not resume_from:
        ckpt_step, missing = checkpoints.restore_params_partial(
            load_model_weights_from_checkpoint, net)
        print(f"warm-started from step {ckpt_step}; {len(missing)} temporal/motion params "
              "kept at init", flush=True)
        if train_temporal_modules_only:
            kept = set(missing)
            for name, p in net.named_parameters():
                p.requires_grad_(name in kept)
            trained = [p for name, p in net.named_parameters() if name in kept]
            print(f"temporal-only fine-tuning: {len(trained)} trainable param tensors, "
                  "backbone frozen", flush=True)
    tx = build_optimizer(config, trained)
    state = create_train_state(model, tx, seed=seed + 1)
    start_step = 0
    if resume_from:
        state, start_step = checkpoints.restore_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)

    latent = prepare_latent_encoder(
        first, load_vae_weights_from_checkpoint,
        lambda: next(batch_iterator(dataset, batch_size, seed=seed))["videos"], seed)
    # A latent process's videos keep the data's frames and size, the VAE's
    # input; its scale took the stream's first batch, as in JAX.
    data = config.get("data")
    shape = (dict(frames=int(data.input_number_of_frames), size=int(data.image_size))
             if latent else {})

    train_step = make_train_step(model)
    needs_text = is_text_conditional(model)
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed,
                                      skip=start_step + int(latent)))
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
            videos, first.config(), mask_generator=None if is_image_batch else mask_generator,
            rng=rng, **shape)
        if use_fdm and not is_image_batch:
            videos, fi, observed, latent = sample_fdm_training_batch(
                videos, videos.shape[1], method=fdm_method, rng=rng)
            extra.update(video_mask=latent.astype(bool), observed_mask=observed,
                         frame_indices=fi)

        device_batch: Dict = {"images": _to(model.device, videos),
                              "frame_indices": _to(model.device, extra["frame_indices"])}
        for key in ("video_mask", "observed_mask"):
            if extra.get(key) is not None:
                device_batch[key] = _to(model.device, extra[key])
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
    video, and the animated <out_dir>/sample-<step>.gif; returns the PNG's
    path."""
    context = {}
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(num_samples)]
    generator = torch.Generator(device=model.device).manual_seed(step)
    samples = model.sample(num_samples=num_samples, context=context,
                           num_sampling_steps=sampling_steps or None, generator=generator)
    videos = samples.float().cpu().numpy()
    path = os.path.join(out_dir, f"sample-{step}.png")
    save_video_strip(videos, path)
    save_gif(videos, os.path.join(out_dir, f"sample-{step}.gif"))
    return path
