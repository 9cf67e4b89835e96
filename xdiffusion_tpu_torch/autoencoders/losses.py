"""VAE-GAN training losses: the PatchGAN discriminators and the
reconstruction / KL / adversarial objective.

Counterpart of xdiffusion_tpu/autoencoders/losses.py (LDM's
LPIPSWithDiscriminator): pixel L1 or L2, the perceptual distance and the 3-D
Haar wavelet L1 of perceptual.py, the NLL under a learned log-variance, KL,
and a hinge or vanilla PatchGAN, 2-D or 3-D (with frames folded into the
batch for a 2-D one), or the paired reconstruction GAN. The discriminators
normalise with flax's plain GroupNorm (eps 1e-6), here F.group_norm, not
K3: the JAX package routes them through no kernel either.

The autoencoder phase composes nll + kl_weight * kl + disc_factor *
adversarial weight * g_loss, as the JAX package does on purpose (the
original project's ternary drops the KL and adversarial terms whenever it
uses the NLL). The adaptive adversarial weight is the grad-norm ratio of the
NLL and the generator loss at the decoder's output convolution: JAX takes
both from one jax.vjp, the port from two torch.autograd.grad calls on that
weight that keep the graph.

Step gates (disc_start, kl_start, ...) compare the Python step count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import Conv
from xdiffusion_tpu_torch.layers.resnet import num_groups_for


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` (eps 1e-6) over the trailing channel axis."""

    def __init__(self, channels: int, num_groups: int, epsilon: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.movedim(-1, 1), self.num_groups, self.scale, self.bias, self.epsilon)
        return y.movedim(1, -1)


class NLayerDiscriminator(nn.Module):
    """The PatchGAN: conv_in, then n_layers - 1 strided conv/GroupNorm/leaky
    stages, conv_last and conv_out; 4x4 kernels, (2, 2) strides."""

    kernel: Tuple[int, ...] = (4, 4)
    first_stride: Tuple[int, ...] = (2, 2)
    stride: Tuple[int, ...] = (2, 2)

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, output_nc: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = Conv(input_nc, ndf, self.kernel, self.first_stride)
        nf_prev = ndf
        for n in range(1, n_layers):
            nf = min(ndf * 2 ** n, ndf * 8)
            self.add_module(f"conv_{n}", Conv(nf_prev, nf, self.kernel, self.stride, bias=False))
            self.add_module(f"norm_{n}", GroupNorm(nf, num_groups_for(nf)))
            nf_prev = nf
        nf = min(ndf * 2 ** n_layers, ndf * 8)
        self.conv_last = Conv(nf_prev, nf, self.kernel, 1, bias=False)
        self.norm_last = GroupNorm(nf, num_groups_for(nf))
        self.conv_out = Conv(nf, output_nc, self.kernel, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv_in(x), 0.2)
        for n in range(1, self.n_layers):
            h = getattr(self, f"conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm_{n}")(h), 0.2)
        h = F.leaky_relu(self.norm_last(self.conv_last(h)), 0.2)
        return self.conv_out(h)


class NLayerDiscriminator3D(NLayerDiscriminator):
    """The 3-D PatchGAN over (B, F, H, W, C) clips: (3, 4, 4) kernels, the
    first stride keeping time, then (2, 2, 2)."""

    kernel = (3, 4, 4)
    first_stride = (1, 2, 2)
    stride = (2, 2, 2)


def _gate(step: int, start: int, value: float) -> float:
    return value if int(step) >= start else 0.0


def adaptive_adversarial_weight(nll_loss: torch.Tensor, g_loss: torch.Tensor,
                                last_layer: torch.Tensor) -> torch.Tensor:
    """|d nll / d w| / (|d g / d w| + 1e-4) at the decoder's last weight w,
    clamped to [0, 1e4], without gradient. Both pulls keep the graph."""
    nll_grads, = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)
    g_grads, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    d_weight = (torch.linalg.vector_norm(nll_grads)
                / (torch.linalg.vector_norm(g_grads) + 1e-4))
    return d_weight.clamp(0.0, 1e4).detach()


class LPIPSWithDiscriminator(nn.Module):
    """Two-phase VAE-GAN loss: optimizer_idx 0 trains the autoencoder, 1 the
    discriminator. Holds `logvar` (a scalar) and `discriminator`: the
    `disc` parameter group of the trainers, as in the JAX package, where the
    autoencoder phase takes no gradient in it and `logvar` stays at
    `logvar_init`."""

    def __init__(self, disc_start: int = 0, kl_weight: float = 1e-6, disc_weight: float = 0.5,
                 perceptual_weight: float = 0.0, disc_factor: float = 1.0,
                 logvar_init: float = 0.0, disc_in_channels: int = 3, disc_num_layers: int = 3,
                 disc_loss: str = "hinge", pixelloss_weight: float = 1.0, rec_loss: str = "l1",
                 use_3d: bool = False, kl_start: int = 0, perceptual_start: int = 0,
                 adversarial_start: int = -1, adversarial_weight: float = -1.0,
                 disc_conditional: bool = False, wavelet_start: int = 0,
                 wavelet_loss_weight: float = 0.0, use_3d_conv: bool = False,
                 use_reconstruction_gan: bool = False, learned_logvar: bool = True,
                 use_nll: bool = True, use_adaptive_adversarial_weight: bool = True):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {disc_loss!r}: hinge or vanilla")
        self.disc_start, self.kl_weight, self.disc_weight = disc_start, kl_weight, disc_weight
        self.perceptual_weight, self.disc_factor = perceptual_weight, disc_factor
        self.pixelloss_weight, self.rec_loss, self.use_3d = pixelloss_weight, rec_loss, use_3d
        self.kl_start, self.perceptual_start = kl_start, perceptual_start
        self.adversarial_start = adversarial_start if adversarial_start >= 0 else disc_start
        self.adversarial_weight = adversarial_weight if adversarial_weight >= 0 else disc_weight
        self.wavelet_start, self.wavelet_loss_weight = wavelet_start, wavelet_loss_weight
        self.use_reconstruction_gan = use_reconstruction_gan
        self.learned_logvar, self.use_nll = learned_logvar, use_nll
        self.use_adaptive_adversarial_weight = use_adaptive_adversarial_weight
        self.d_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.logvar = nn.Parameter(torch.full((), float(logvar_init)))
        disc_cls = NLayerDiscriminator3D if use_3d else NLayerDiscriminator
        pair = 2 if use_reconstruction_gan else 1
        self.discriminator = disc_cls(input_nc=disc_in_channels * pair, ndf=64,
                                      n_layers=disc_num_layers, output_nc=pair)

    def forward(self, inputs: torch.Tensor, reconstructions: torch.Tensor, posterior,
                optimizer_idx: int, global_step: int,
                adaptive_weight: Optional[torch.Tensor] = None,
                return_nll_g: bool = False, last_layer: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`last_layer`: the decoder's output weight, from which the
        autoencoder phase computes the adaptive weight when it uses one and
        none is given."""
        diff = inputs - reconstructions
        rec_loss = self.pixelloss_weight * (diff ** 2 if self.rec_loss == "l2" else diff.abs())
        zero = torch.zeros((), device=inputs.device)
        p_loss = zero
        if self.perceptual_weight > 0.0:
            from xdiffusion_tpu_torch.autoencoders.perceptual import perceptual_distance

            p = perceptual_distance(inputs, reconstructions)
            rec_loss = rec_loss + _gate(global_step, self.perceptual_start,
                                        self.perceptual_weight) * p
            p_loss = p.mean()
        w_loss = zero
        if self.wavelet_loss_weight > 0.0:
            from xdiffusion_tpu_torch.autoencoders.perceptual import wavelet_loss_3d

            if inputs.ndim != 5:
                raise ValueError("wavelet loss needs (B, F, H, W, C) video")
            w = wavelet_loss_3d(reconstructions, inputs)
            rec_loss = rec_loss + _gate(global_step, self.wavelet_start,
                                        self.wavelet_loss_weight) * w
            w_loss = w.mean()

        if self.learned_logvar:
            logvar = self.logvar
        else:
            axes = tuple(range(1, posterior.logvar.ndim))
            logvar = posterior.logvar.mean(dim=axes).reshape((-1,) + (1,) * (rec_loss.ndim - 1))
        if self.use_nll:
            nll = rec_loss / torch.exp(logvar) + logvar
            nll_loss = nll.sum() / nll.shape[0]
        else:
            nll_loss = rec_loss.mean()
        kl_loss = _gate(global_step, self.kl_start, 1.0) * posterior.kl().mean()

        disc_in, disc_rec = inputs, reconstructions
        if inputs.ndim == 5 and not self.use_3d:
            disc_in = inputs.reshape(-1, *inputs.shape[2:])
            disc_rec = reconstructions.reshape(-1, *reconstructions.shape[2:])
        disc_on = _gate(global_step, self.adversarial_start, self.disc_factor)

        if optimizer_idx == 0:
            if self.use_reconstruction_gan:
                logits = self.discriminator(torch.cat([disc_rec, disc_in], dim=-1))
                logits_fake = logits.chunk(2, dim=-1)[0]
            else:
                logits_fake = self.discriminator(disc_rec)
            g_loss = -logits_fake.mean()
            if return_nll_g:
                return nll_loss, g_loss
            if (adaptive_weight is None and last_layer is not None
                    and self.use_adaptive_adversarial_weight):
                adaptive_weight = adaptive_adversarial_weight(nll_loss, g_loss, last_layer)
            adv_weight = self.adversarial_weight
            if adaptive_weight is not None:
                adv_weight = adaptive_weight * adv_weight
            loss = nll_loss + self.kl_weight * kl_loss + disc_on * adv_weight * g_loss
            return loss, {
                "total_loss": loss, "nll_loss": nll_loss, "kl_loss": kl_loss, "g_loss": g_loss,
                "p_loss": p_loss, "w_loss": w_loss,
                "d_weight": torch.as_tensor(adv_weight, dtype=torch.float32,
                                            device=inputs.device),
                "logvar": logvar.mean(),
            }

        disc_in, disc_rec = disc_in.detach(), disc_rec.detach()
        if self.use_reconstruction_gan:
            logits_fake_a, logits_real_a = self.discriminator(
                torch.cat([disc_rec, disc_in], dim=-1)).chunk(2, dim=-1)
            logits_real_b, logits_fake_b = self.discriminator(
                torch.cat([disc_in, disc_rec], dim=-1)).chunk(2, dim=-1)
            disc_loss = (self.d_fn(logits_real_a, logits_fake_a)
                         + self.d_fn(logits_real_b, logits_fake_b))
            logits_real = logits_real_a + logits_real_b
            logits_fake = logits_fake_a + logits_fake_b
        else:
            logits_real = self.discriminator(disc_in)
            logits_fake = self.discriminator(disc_rec)
            disc_loss = self.d_fn(logits_real, logits_fake)
        d_loss = disc_on * disc_loss
        return d_loss, {"disc_loss": d_loss, "logits_real": logits_real.mean(),
                        "logits_fake": logits_fake.mean()}
