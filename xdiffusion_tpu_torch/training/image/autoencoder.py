"""VAE-GAN training loop: an autoencoder phase and a discriminator phase a
step.

Counterpart of xdiffusion_tpu/training/image/autoencoder.py on one device.
A step trains the autoencoder (`ae`) against the frozen discriminator, then
the discriminator (`disc`: the discriminator and the loss's log-variance,
which takes no gradient in either phase, as in JAX) on reconstructions made,
without gradients, by the updated autoencoder. Both optimizers are
Adam(learning_rate, betas (0.5, 0.9)) without clipping, as there. Each
phase's posterior draw comes from the state's generator, or from
batch["noise_ae"] / batch["noise_disc"].

A checkpoint (checkpoints.write_payload) holds the parameters, both
optimizers and the generator; a resumed run skips the batches the
interrupted one consumed, so it repeats the uninterrupted run. The JAX
trainer restarts its batch stream on a resume.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from xdiffusion_tpu_torch import checkpoints
from xdiffusion_tpu_torch.config import instantiate_from_config, load_yaml
from xdiffusion_tpu_torch.datasets import load_dataset
from xdiffusion_tpu_torch.datasets.utils import batch_iterator, prefetch
from xdiffusion_tpu_torch.optim import Adam, GradientTransform
from xdiffusion_tpu_torch.training.common import MetricsLogger, save_image_grid


@dataclass
class VAETrainState:
    """step: updates taken; vae: the autoencoder, which holds `ae` and `disc`;
    opt_ae, opt_disc: their optimizers; generator: the posterior draws'."""

    step: int
    vae: torch.nn.Module
    opt_ae: GradientTransform
    opt_disc: GradientTransform
    generator: torch.Generator


def create_vae_train_state(vae, learning_rate: float = 4.5e-6, seed: int = 0) -> VAETrainState:
    def adam(module):
        return Adam(lr=learning_rate, betas=(0.5, 0.9), grad_clip=None).build(module.parameters())

    return VAETrainState(0, vae, adam(vae.ae), adam(vae.disc),
                         torch.Generator(device=vae.device).manual_seed(seed))


def make_vae_train_step(vae) -> Callable[[VAETrainState, Dict], Dict]:
    """`step(state, batch) -> metrics`: batch["images"] (B, [F,] H, W, C) in
    [0, 1] on the VAE's device. metrics: loss_ae, loss_disc and the
    autoencoder phase's logs (total_loss, nll_loss, kl_loss, g_loss, ...)."""

    def step(state: VAETrainState, batch: Dict) -> Dict:
        images = batch["images"]
        state.opt_ae.zero_grad()
        vae.disc.requires_grad_(False)
        try:
            loss_ae, logs = vae.training_losses(images, 0, state.step, noise=batch.get("noise_ae"),
                                                generator=state.generator)
            loss_ae.backward()
        finally:
            vae.disc.requires_grad_(True)
        state.opt_ae.step()

        state.opt_disc.zero_grad()
        loss_d, _ = vae.training_losses(images, 1, state.step, noise=batch.get("noise_disc"),
                                        generator=state.generator)
        loss_d.backward()
        state.opt_disc.step()
        state.step += 1
        metrics = {"loss_ae": loss_ae.detach(), "loss_disc": loss_d.detach()}
        metrics.update({k: v.detach() for k, v in logs.items()})
        return metrics

    return step


def save_vae_checkpoint(directory: str, state: VAETrainState, step: int) -> str:
    return checkpoints.write_payload(directory, step, {
        "params": state.vae.state_dict(), "opt_ae": state.opt_ae.state_dict(),
        "opt_disc": state.opt_disc.state_dict(), "generator": state.generator.get_state()})


def restore_vae_checkpoint(path: str, state: VAETrainState):
    """Loads a checkpoint (file, or checkpoint or run directory: its latest)
    into `state` in place; returns (state, step)."""
    payload = checkpoints.read_payload(path, state.vae.device)
    state.vae.load_state_dict(payload["params"])
    state.opt_ae.load_state_dict(payload["opt_ae"])
    state.opt_disc.load_state_dict(payload["opt_disc"])
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    return state, state.step


def load_vae_params(path: str, device) -> Dict[str, torch.Tensor]:
    """The parameters (`ae.*`, `disc.*`) of a VAE checkpoint."""
    return checkpoints.read_payload(path, device)["params"]


def build_vae(config, device=None):
    """The autoencoder of a config's `autoencoder` block (or `vae_config`)."""
    key = "autoencoder" if "autoencoder" in config else "vae_config"
    return instantiate_from_config(config[key].to_dict(), use_config_struct=True, device=device)


def train_autoencoder(
    config_path: str,
    num_training_steps: int = 10000,
    batch_size: int = 64,
    dataset_name: str = "image/mnist",
    output_path: str = "output",
    save_and_sample_every_n: int = 1000,
    learning_rate: float = 4.5e-6,
    resume_from: Optional[str] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    log_every: int = 50,
) -> str:
    """Trains an image VAE from a YAML config on `device` (CUDA unless "cpu").
    Returns the run directory, <output_path>/<dataset>/<config name>/, with
    metrics.jsonl (loss_ae, loss_disc, kl_loss), reconstruction-<step>.png
    (inputs beside reconstructions) and checkpoints/<step>.pt."""
    config = load_yaml(config_path)
    run_name = os.path.splitext(os.path.basename(config_path))[0]
    out_dir = os.path.join(output_path, dataset_name.replace("/", "_"), run_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    torch.manual_seed(seed)  # the modules' initialisers draw from it
    vae = build_vae(config, device)
    dataset, _ = load_dataset(dataset_name, config=config, split="train")
    n = sum(p.numel() for p in vae.ae.parameters())
    print(f"autoencoder parameters: {n / 1e6:.2f}M on {vae.device}", flush=True)

    state = create_vae_train_state(vae, learning_rate, seed + 1)
    start_step = 0
    if resume_from:
        state, start_step = restore_vae_checkpoint(resume_from, state)
        print(f"resumed from {resume_from} @ step {start_step}", flush=True)
    step_fn = make_vae_train_step(vae)
    batches = prefetch(batch_iterator(dataset, batch_size, seed=seed, skip=start_step))
    logger = MetricsLogger(out_dir)
    t0 = time.time()
    for step in range(start_step, num_training_steps):
        images = torch.from_numpy(next(batches)["images"]).to(vae.device)
        metrics = step_fn(state, {"images": images})
        if step % log_every == 0 or step == num_training_steps - 1:
            logger.log(step, {k: metrics[k] for k in ("loss_ae", "loss_disc", "kl_loss")})
        if (step + 1) % save_and_sample_every_n == 0 or (step + 1) == num_training_steps:
            reconstruct_and_save(vae, images[:16], out_dir, step + 1)
            save_vae_checkpoint(ckpt_dir, state, step + 1)
            print(f"checkpoint + reconstructions saved @ step {step + 1}", flush=True)
    print(f"trained in {time.time() - t0:.1f}s", flush=True)
    logger.close()
    return out_dir


def reconstruct_and_save(vae, images: torch.Tensor, out_dir: str, step: int) -> str:
    """Inputs beside their reconstructions (the posterior drawn from a
    generator seeded by the step), as <out_dir>/reconstruction-<step>.png."""
    generator = torch.Generator(device=vae.device).manual_seed(step)
    with torch.no_grad():
        recon = vae.decode_from_latents(vae.encode_to_latents(images, generator=generator))
    pair = np.concatenate([images.cpu().numpy(), recon.clamp(0, 1).cpu().numpy()], axis=2)
    path = os.path.join(out_dir, f"reconstruction-{step}.png")
    save_image_grid(pair, path)
    return path
