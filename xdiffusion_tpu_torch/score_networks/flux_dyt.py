"""Flux with DynamicTanh (DyT) in place of every norm.

Counterpart of xdiffusion_tpu/score_networks/flux_dyt.py ("Transformers
without Normalization"): the architecture of score_networks/flux.py with
each LayerNorm and each RMS qk-norm replaced by DyT (layers/norm.py)."""

from __future__ import annotations

from xdiffusion_tpu_torch.score_networks.flux import Flux as _Flux


class Flux(_Flux):
    _norm_cls = "dyt"
