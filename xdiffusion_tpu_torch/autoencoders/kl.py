"""KL-regularised image VAE (LDM's AutoencoderKL).

Counterpart of xdiffusion_tpu/autoencoders/kl.py: encoder -> double-z
moments -> 1x1 quant conv -> diagonal Gaussian posterior; the decoder from
the 1x1 post-quant conv. Holds the autoencoder under `ae` (its `encoder`,
`decoder`, `quant_conv`, `post_quant_conv`, the flax tree's names) and the
loss module under `disc` (none for a torch.nn.Identity loss_config, the
frozen-encoder convention).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from xdiffusion_tpu_torch.autoencoders.base import VariationalAutoEncoder
from xdiffusion_tpu_torch.autoencoders.layers import Decoder, Encoder
from xdiffusion_tpu_torch.layers.linear import Conv


class _AutoencoderKLModule(nn.Module):
    def __init__(self, config):
        super().__init__()
        edc = config.encoder_decoder_config.to_dict()
        assert edc["double_z"]
        common = dict(ch=edc["ch"], ch_mult=tuple(edc["ch_mult"]),
                      num_res_blocks=edc["num_res_blocks"], z_channels=edc["z_channels"],
                      attn_resolutions=tuple(edc.get("attn_resolutions", []) or []),
                      resolution=edc.get("resolution", 32), dropout=edc.get("dropout", 0.0))
        self.encoder = Encoder(double_z=True, in_channels=edc.get("in_channels", 3), **common)
        self.decoder = Decoder(out_ch=edc.get("out_ch", edc.get("in_channels", 3)), **common)
        embed_dim = int(config.embed_dim)
        self.quant_conv = Conv(2 * edc["z_channels"], 2 * embed_dim, (1, 1))
        self.post_quant_conv = Conv(embed_dim, edc["z_channels"], (1, 1))

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


class AutoencoderKL(VariationalAutoEncoder):
    """Config-driven (`instantiate_with_config_struct`: the params block
    arrives whole), on `device` (CUDA unless "cpu")."""

    def __init__(self, config, device=None, **kwargs):
        super().__init__(config, device)
        self.latent_channels = int(config.embed_dim)
        self.ae = _AutoencoderKLModule(config)
        self._build_loss(skip_identity=True)
        self._place()
