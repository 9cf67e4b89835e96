"""Perceptual VAE losses under the original project's module path
(xdiffusion_tpu/autoencoders/contperceptual.py): the implementation lives in
losses.py; configs spell the class LPIPS and LPAPS."""

from xdiffusion_tpu_torch.autoencoders.losses import LPIPSWithDiscriminator

LPAPSWithDiscriminator = LPIPSWithDiscriminator

__all__ = ["LPIPSWithDiscriminator", "LPAPSWithDiscriminator"]
