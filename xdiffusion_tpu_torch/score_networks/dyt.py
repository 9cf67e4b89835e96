"""PixArt-alpha with DynamicTanh (DyT) normalisation.

Counterpart of xdiffusion_tpu/score_networks/dyt.py: PixArt-alpha with
every LayerNorm, the final norm included, replaced by DyT (tanh(alpha * x)
with a per-channel affine, "Transformers without Normalization"). The
adaLN-single modulation is unchanged; only the norms swap, through
PixArtAlpha's `norm_cls`.
"""

from __future__ import annotations

from typing import Any

from xdiffusion_tpu_torch.score_networks.pixart import PixArtAlpha as _PixArtAlpha


class PixArtAlphaDyT(_PixArtAlpha):
    """PixArt-alpha with DyT norms unless the config names `norm_cls`."""

    _default_norm_cls = "dyt"


# The name configs/image/mnist/pixart_alpha_dyt.yaml uses.
DyTScoreNetwork = PixArtAlphaDyT


def PixArtAlpha(config: Any, **kwargs) -> _PixArtAlpha:
    return PixArtAlphaDyT(config=config, **kwargs)
