"""Image-diffusion training loop.

Counterpart of xdiffusion_tpu/training/image/train.py on the branches the
UNet, text-conditioned UNet, class-conditional DiT, score-SDE, EDM and
cascade configs take, on one device: the process the config names
(`build_model`; a cascade's stages train together, in one optimizer and one
checkpoint),
config batch precedence, the dataset (real MNIST if present, else the
synthetic digits; their labels go to a class-conditional model, and as
prompts through the config's context preprocessors to a prompt-conditioned
one), the optimizer and the EMA from the config, resume or weight loading,
the loop, metrics every `log_every` steps, and a sample grid (the digits
0-9 in turn for a class-conditional model, the prompts "0" to "9" in turn
for a text-conditional one) plus a checkpoint every
`save_and_sample_every_n` steps and at the end. A prompt's surface form
("3" or "three") is drawn from np.random.default_rng((seed, step)), so a
resumed run repeats the prompts (the JAX package draws them unseeded).
Latent diffusion (`vae_checkpoint`, `prepare_latent_encoder`): the frozen
VAE's weights come from an autoencoder trainer's checkpoint, and the latent
scale from the stream's first batch, which training then skips, as in JAX;
a resume recomputes the same scale from the same batch. Meshes raise
`NotImplementedError`; `mixed_precision` is accepted and ignored, as in the
JAX trainer.

The trainer extras, as in the JAX trainer: the start-up model summary
(summary.py), TensorBoard events of the metrics and sample grids
(training/common.py); LoRA fine-tuning (`use_lora_training`, `lora_rank`:
lora.py; the optimizer, EMA and checkpoints hold the factors only, the
grids sample base + EMA factors, and `lora_weights.pkl` is written at each
save); gradient accumulation (`gradient_accumulation_steps`: optim.py
`MultiSteps`; the EMA runs every mini-step); the config's importance
sampler (an `ImportanceSampler`'s state on the device in the train state
and its checkpoints; a host-only sampler draws on the host from
np.random.default_rng((seed, step, 1)), where JAX draws unseeded); a
`torch.profiler` trace of 3 steps from `profile_start_step`, and
`debug_nans` (profiling.py), which also raises on a NaN loss.

Under LoRA the frozen base is `load_model_weights_from_checkpoint`'s (in a
resumed run too, whose checkpoint then restores the factors, their
optimizer state and their EMA), or the fresh init without it. The JAX
trainer restores that checkpoint into its LoRA tree and fails on the
mismatch (ROADMAP queue 3).

Unlike the JAX trainer, the port feeds prompts to a cascade whose stages
take them (`imagen.yaml`) and samples its grids with prompts: the JAX
trainer looks for preprocessors on the cascade itself, finds none, and the
first stage's forward raises on the missing `text_tokens`. A
super-resolution stage trained alone raises as in JAX: the trainer gives
it no `low_resolution_images`, and its first loss raises a KeyError.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import numpy as np
import torch
from torch.nn.utils import parametrize

from xdiffusion_tpu_torch import checkpoints
from xdiffusion_tpu_torch import lora as lora_lib
from xdiffusion_tpu_torch.config import (
    DotConfig,
    get_obj_from_str,
    instantiate_from_config,
    is_class_conditional,
    load_yaml,
)
from xdiffusion_tpu_torch.datasets import load_dataset
from xdiffusion_tpu_torch.datasets.utils import batch_iterator, prefetch
from xdiffusion_tpu_torch.diffusion.consistency import GaussianDiffusion_ConsistencyModel
from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
from xdiffusion_tpu_torch.optim import GradientTransform, MultiSteps, default_optimizer
from xdiffusion_tpu_torch.profiling import StepProfiler, nan_debugging
from xdiffusion_tpu_torch.summary import print_model_summary
from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
from xdiffusion_tpu_torch.training.common import (
    MetricsLogger,
    is_text_conditional,
    save_image_grid,
)


def build_model(config: DotConfig, device=None):
    """The diffusion process a config names: a cascade
    (`diffusion_cascade`), its top-level `target` (the score-SDE, EDM and
    consistency processes), else the DDPM process, on `device`."""
    if "diffusion_cascade" in config:
        from xdiffusion_tpu_torch.diffusion.cascade import GaussianDiffusionCascade

        return GaussianDiffusionCascade(config, device=device)
    if "target" in config:
        return get_obj_from_str(config.to_dict()["target"])(config, device=device)
    return GaussianDiffusion_DDPM(config, device=device)


def build_optimizer(config: DotConfig, params) -> GradientTransform:
    opt = (instantiate_from_config(config.optimizer.to_dict())
           if "optimizer" in config else default_optimizer())
    schedule = None
    if "learning_rate_schedule" in config:
        schedule = instantiate_from_config(config.learning_rate_schedule.to_dict())
    return opt.build(params, schedule)


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
    # `mixed_precision` is taken and not read, as in the JAX trainer: the
    # compute dtype comes from the config.
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
    if isinstance(model, GaussianDiffusion_ConsistencyModel):
        # JAX's trainer fails on it too, on the missing context["num_scales"].
        raise ValueError(f"{config_path}: a consistency model trains through "
                         "`python -m xdiffusion_tpu_torch.distill_consistency`, which runs "
                         "its N-scales schedule and target network")
    print_model_summary(model)
    net = model.score_network()
    n_params = sum(p.numel() for p in net.parameters())
    print(f"score network parameters: {n_params / 1e6:.2f}M on {model.device}", flush=True)
    # A host-side preprocessor of the grids' sampling context (a text embedder).
    prompt_encoder = None
    if "sampling" in config and "prompt_encoder" in config.sampling:
        prompt_encoder = instantiate_from_config(config.sampling.prompt_encoder.to_dict())
    # Prompts go through the config's context preprocessors, or through the
    # score network's host-side prompt projection (PixArt's T5 tokens). The
    # JAX trainer looks at the preprocessors only, so it feeds a PixArt text
    # config no prompts, and its forward then finds no text tokens.
    uses_prompts = (any(type(p).__name__ != "IgnoreContextAdapter"
                        for p in model._context_preprocessors)
                    or model._host_prompt_projection is not None)
    # None, or a uniform sampler: the process draws its own timesteps.
    importance = model.importance_sampler()
    device_importance = importance is not None and hasattr(importance, "init_device_state")
    host_importance = (importance is not None and not device_importance
                       and not importance.device_side)

    dataset, convert_labels_to_prompts = load_dataset(dataset_name, config=config,
                                                      split="train")
    if getattr(dataset, "synthetic", False):
        print("=" * 70 + f"\nWARNING: {dataset_name} archives not found - training on "
              "the SYNTHETIC stand-in dataset. Quality metrics from this run are not "
              "comparable to real-data numbers.\n" + "=" * 70, flush=True)

    # LoRA adapts the base the checkpoint names, also in a resumed run.
    if load_model_weights_from_checkpoint and (use_lora_training or not resume_from):
        checkpoints.load_params(load_model_weights_from_checkpoint, net)
    lora = None
    if use_lora_training:
        generator = torch.Generator(device=model.device).manual_seed(seed + 11)
        lora = lora_lib.inject_trainable_lora(net, generator, r=lora_rank)
        lora_lib.attach(net, lora)
        print(f"LoRA fine-tuning: rank {lora_rank}, "
              f"{lora_lib.lora_param_count(lora) / 1e6:.3f}M trainable (base frozen)", flush=True)
    tx = build_optimizer(config, (lora if lora is not None else net).parameters())
    if gradient_accumulation_steps > 1:
        tx = MultiSteps(tx, gradient_accumulation_steps)
    ema_cfg = config.get("training")
    use_ema = bool(ema_cfg and ema_cfg.get("ema_decay"))
    device_sampler = importance if device_importance else None
    state = create_train_state(model, tx, ema=use_ema, seed=seed + 1,
                               importance_sampler=device_sampler, lora=lora)

    start_step = 0
    if resume_from:
        state, start_step = checkpoints.restore_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)

    latent = prepare_latent_encoder(
        model, vae_checkpoint, lambda: next(batch_iterator(dataset, batch_size, seed=seed))["images"],
        seed)

    # A cascade's class conditioning is its first stage's, as JAX reads it.
    class_conditional = is_class_conditional(
        config if "diffusion" in config else model.models()[0].config())
    ema_decay = float(ema_cfg.get("ema_decay")) if use_ema else None
    train_step = make_train_step(model, ema_decay=ema_decay, param_transform=lora,
                                 importance_sampler=device_sampler)
    # A latent process's scale took the stream's first batch, as in JAX.
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed,
                                      skip=start_step + int(latent)))

    logger = MetricsLogger(out_dir)
    profiler = StepProfiler(out_dir, start_step=profile_start_step)
    t_start = time.time()
    with nan_debugging(net, enable=debug_nans):
        for step in range(start_step, num_training_steps):
            profiler.maybe_start(step)
            batch = next(batches)
            device_batch = {"images": torch.from_numpy(batch["images"]).to(model.device)}
            if class_conditional:
                device_batch["classes"] = torch.from_numpy(batch["classes"]).to(model.device)
            if uses_prompts:
                # Label -> prompt -> tokens or embeddings on the host; only
                # tensors move.
                prompts = convert_labels_to_prompts(batch["classes"],
                                                    rng=np.random.default_rng((seed, step)))
                ctx = model.preprocess_context({"text_prompts": prompts})
                device_batch.update({k: v.to(model.device) for k, v in ctx.items()
                                     if isinstance(v, torch.Tensor)})
            if host_importance:
                t, w = importance.sample(batch_size, rng=np.random.default_rng((seed, step, 1)))
                device_batch["timesteps"] = torch.from_numpy(t).long().to(model.device)
                device_batch["loss_weights"] = torch.from_numpy(w).to(model.device)
            metrics = train_step(state, device_batch)
            profiler.maybe_stop(step)
            if debug_nans and torch.isnan(metrics["loss"]):
                raise FloatingPointError(f"NaN loss at step {step}")
            if host_importance:
                importance.update_with_all_losses(
                    metrics["timesteps"].cpu().numpy(),
                    metrics["loss_per_example"].detach().cpu().numpy())

            if step % log_every == 0 or step == num_training_steps - 1:
                logger.log(step, {k: metrics[k] for k in
                                  ("loss", "mse_loss", "vb_loss", "grad_norm", "moe_aux_loss")
                                  if k in metrics})

            if (step + 1) % save_and_sample_every_n == 0 or (step + 1) == num_training_steps:
                # A class-conditional model samples the digits 0-9 in turn,
                # with the config's guidance when asked for; as in the JAX
                # package, an unconditional model samples without guidance.
                sample_and_save(model, state, out_dir, step + 1, num_samples=num_samples,
                                guidance=sample_with_guidance,
                                is_class_conditional=class_conditional,
                                prompt_encoder=prompt_encoder, logger=logger)
                checkpoints.save_checkpoint(ckpt_dir, state, step + 1)
                if lora is not None:
                    lora_lib.save_lora_weights(lora, os.path.join(out_dir, "lora_weights.pkl"))
                print(f"checkpoint + samples saved @ step {step + 1}", flush=True)
    profiler.close()

    wall = time.time() - t_start
    steps_done = num_training_steps - start_step
    print(f"trained {steps_done} steps in {wall:.1f}s "
          f"({steps_done / max(wall, 1e-9):.2f} steps/s)", flush=True)
    logger.close()
    return out_dir


def prepare_latent_encoder(model, vae_checkpoint: Optional[str], first_batch,
                           seed: int) -> bool:
    """For a latent process (one with a `latent_encoder`): loads the VAE's
    parameters from `vae_checkpoint` (a VAE run directory or `.pt` of the
    autoencoder trainers) when given, else keeps its initial ones, and fixes
    the latent scale from `first_batch()`'s samples (the stream's first
    batch, as a numpy array), the posterior drawn from a generator
    seeded by seed + 8. Returns whether the process is latent; a pixel-space
    one ignores the checkpoint, as the JAX trainers do."""
    encoder = getattr(model, "latent_encoder", lambda: None)()
    if encoder is None:
        return False
    if vae_checkpoint:
        from xdiffusion_tpu_torch.training.image.autoencoder import load_vae_params

        model.set_latent_encoder_params(load_vae_params(vae_checkpoint, model.device))
        print(f"loaded frozen VAE from {vae_checkpoint}", flush=True)
    generator = torch.Generator(device=model.device).manual_seed(seed + 8)
    scale = model.compute_latent_scale(torch.from_numpy(first_batch()).to(model.device),
                                       generator=generator)
    print(f"latent scale factor: {scale:.4f}", flush=True)
    return True


@contextlib.contextmanager
def _sampling_params(model, state):
    """Samples from the EMA parameters when the state tracks them: under
    LoRA, base + the EMA factors (else the factors), each adapted weight
    built once for the whole grid."""
    if state.lora is not None:
        saved = None
        if state.ema is not None:
            saved = {k: v.clone() for k, v in state.lora.state_dict().items()}
            state.lora.load_state_dict(state.ema.state_dict())
        try:
            with parametrize.cached():
                yield
        finally:
            if saved is not None:
                state.lora.load_state_dict(saved)
        return
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


def sample_and_save(model, state, out_dir: str, step: int, num_samples: int = 64,
                    guidance: bool = False, is_class_conditional: bool = False,
                    prompt_encoder=None, logger=None) -> str:
    """Samples with the config's sampler (from the EMA parameters when
    present) and writes <out_dir>/sample-<step>.png; returns its path. A
    class-conditional model samples classes arange(num_samples) % 10, a
    text-conditional one the prompts "0" to "9" in turn, with the config's
    classifier-free guidance when `guidance` is set. `prompt_encoder`, the
    config's sampling.prompt_encoder, preprocesses the context first. The
    grid also goes to `logger`'s TensorBoard events as "samples"."""
    generator = torch.Generator(device=model.device).manual_seed(step)
    context, cfg_value = {}, None
    if is_class_conditional:
        context["classes"] = torch.arange(num_samples, device=model.device) % 10
        if guidance:
            cfg_value = model.classifier_free_guidance()
    if is_text_conditional(model):
        context["text_prompts"] = [str(i % 10) for i in range(num_samples)]
        if guidance:
            cfg_value = model.classifier_free_guidance()
    if prompt_encoder is not None:
        context = prompt_encoder(context)
    with _sampling_params(model, state):
        samples = model.sample(num_samples=num_samples, context=context,
                               classifier_free_guidance=cfg_value, generator=generator)
    path = os.path.join(out_dir, f"sample-{step}.png")
    samples = samples.float().cpu().numpy()
    save_image_grid(samples, path)
    if logger is not None:
        logger.log_image_grid("samples", samples, step)
    return path
