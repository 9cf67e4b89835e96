"""OpenSora's Hunyuan-style causal 3-D KL VAE.

Counterpart of
xdiffusion_tpu/autoencoders/opensora/hunyuan/autoencoder_kl_causal_3d.py:
hunyuan.py's architecture with per-channel moments, the config's latent
scale and shift applied in encode (z = scale * (z - shift)) and inverted in
decode, and its tiling flags read from the config.
"""

from __future__ import annotations

from xdiffusion_tpu_torch.autoencoders.hunyuan import HunyuanCausal3DVAE
from xdiffusion_tpu_torch.config import DotConfig


class AutoencoderKLCausal3D(HunyuanCausal3DVAE):
    def __init__(self, config=None, device=None, **kwargs):
        if config is None:
            config = DotConfig(dict(kwargs))
        if "latent_logvar" not in config:
            config._cfg["latent_logvar"] = "per_channel"
        super().__init__(config, device)
        self.scale_factor = float(config.get("scale_factor", 0.476986))
        self.shift_factor = float(config.get("shift_factor", 0.0))
        self.use_spatial_tiling = bool(config.get("use_spatial_tiling", False))
        self.use_temporal_tiling = bool(config.get("use_temporal_tiling", False))
        self.tile_overlap_factor = float(config.get("tile_overlap_factor", 0.25))

    def encode_to_latents(self, x, noise=None, generator=None):
        return self.scale_factor * (super().encode_to_latents(x, noise, generator)
                                    - self.shift_factor)

    def decode_from_latents(self, z, **kwargs):
        return super().decode_from_latents(z / self.scale_factor + self.shift_factor)
