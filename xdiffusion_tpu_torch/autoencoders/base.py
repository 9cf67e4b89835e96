"""The autoencoder protocol and what every autoencoder of the port shares.

Counterpart of xdiffusion_tpu/autoencoders/base.py. There an autoencoder is
a wrapper of flax modules, and its params arrive as {"ae": ..., "disc": ...}
in every call; here it is an `nn.Module` that holds them: the autoencoder's
under `ae` (encode_moments / decode), the loss module's
(losses.LPIPSWithDiscriminator: the discriminator and the learned
log-variance) under `disc`, None for a frozen latent encoder. Its entry
points run on CUDA unless "cpu" is asked for, and raise without a card.

Randomness: the posterior's standard-normal draw is `noise` when given,
else drawn from `generator` (the JAX package draws it from a key).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.autoencoders.distributions import (
    DiagonalGaussianDistribution,
    moments_to_distribution,
)
from xdiffusion_tpu_torch.config import instantiate_from_config
from xdiffusion_tpu_torch.utils import resolve_device


class VariationalAutoEncoder(nn.Module):
    """A subclass builds `ae` (a module with encode_moments(x) and decode(z))
    and calls `_build_loss` and `_place`; `latent_channels` sizes the
    posterior. `last_layer_marker` names the decoder's output convolution,
    whose weight the adaptive adversarial weight differentiates against."""

    last_layer_marker = "decoder.conv_out"

    def __init__(self, config, device=None):
        super().__init__()
        self._config = config
        self.device = resolve_device(device)
        self.disc = None

    def _build_loss(self, skip_identity: bool = False) -> None:
        """The config's loss_config as `disc`; `skip_identity`: a
        torch.nn.Identity target means none (the KL VAE's convention)."""
        cfg = self._config.get("loss_config")
        if cfg is None or (skip_identity and cfg.target.endswith("Identity")):
            return
        self.disc = instantiate_from_config(cfg.to_dict())

    def _place(self) -> None:
        self.to(self.device)

    @property
    def loss_module(self):
        return self.disc

    # -- the protocol ---------------------------------------------------------

    def fit_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The inputs as the autoencoder encodes them (LTX: its frame count)."""
        return x

    def posterior(self, moments: torch.Tensor) -> DiagonalGaussianDistribution:
        return moments_to_distribution(moments, self.latent_channels)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.ae.encode_moments(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.ae.decode(z)

    def encode_to_latents(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Samples in [0, 1] -> posterior samples, without gradients."""
        with torch.no_grad():
            x = self.fit_inputs(x)
            return self.posterior(self.encode_moments(x)).sample(noise, generator)

    def decode_from_latents(self, z: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.decode(z)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, DiagonalGaussianDistribution]:
        """(reconstruction cut to x's leading extent, posterior): a causal
        decoder may emit more frames than it was given."""
        posterior = self.posterior(self.encode_moments(x))
        recon = self.decode(posterior.sample(noise, generator))
        return recon[:, :x.shape[1]], posterior

    # -- training -------------------------------------------------------------

    def last_layer(self) -> nn.Parameter:
        """The weight of the decoder's output convolution (the JAX package's
        `find_kernel_path(params["ae"], marker)`)."""
        hits = [p for name, p in self.ae.named_parameters()
                if self.last_layer_marker in name and name.endswith("weight")]
        if len(hits) != 1:
            raise ValueError(f"expected one weight matching {self.last_layer_marker!r}, "
                             f"got {len(hits)}")
        return hits[0]

    def training_losses(self, inputs: torch.Tensor, optimizer_idx: int, global_step: int,
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The VAE-GAN objective of phase `optimizer_idx`: 0, the
        autoencoder's, differentiable in `ae` (with the adaptive adversarial
        weight when the loss asks for it); 1, the discriminator's, on
        reconstructions made without gradients. The posterior's draw is
        `noise`, else drawn from `generator`."""
        if self.disc is None:
            raise ValueError("training_losses: the config has no loss_config")
        inputs = self.fit_inputs(inputs)
        with torch.set_grad_enabled(torch.is_grad_enabled() and optimizer_idx == 0):
            recon, posterior = self(inputs, noise=noise, generator=generator)
        return self.disc(inputs, recon, posterior, optimizer_idx, global_step,
                         last_layer=self.last_layer() if optimizer_idx == 0 else None)
