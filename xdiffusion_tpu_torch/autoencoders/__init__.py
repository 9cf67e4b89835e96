"""Autoencoders: the latent spaces of latent diffusion, and their VAE-GAN
training objective.

Counterpart of xdiffusion_tpu/autoencoders/: the LTX-Video, HunyuanVideo
and OpenSora causal video VAEs, the shared causal VAE of causal_video.py,
the LDM-style KL image VAE, and the perceptual, wavelet and adversarial
losses. Every autoencoder is an `nn.Module` (base.py) that holds its
parameters: the autoencoder's under `ae`, the loss module's (the
discriminator and the learned log-variance) under `disc`, the two groups
that the VAE-GAN trainers give their own optimizers.
"""

from xdiffusion_tpu_torch.autoencoders.base import VariationalAutoEncoder  # noqa: F401
