"""Frame-mask generators for video diffusion training.

The port's copy of xdiffusion_tpu/masking.py, host numpy. Masks are (B, T)
booleans: True = generate this frame, False = condition on it. For the same
`np.random.Generator` they equal the JAX package's bit for bit. Videos are
frames-first NHWC: (B, F, H, W, C).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


class MaskGenerator:
    def get_masks(self, shape, rng: Optional[np.random.Generator] = None
                  ) -> np.ndarray:
        raise NotImplementedError


class IdentityMaskGenerator(MaskGenerator):
    """All frames generated (no conditioning)."""

    def __init__(self, **kwargs):
        pass

    def get_masks(self, shape, rng=None) -> np.ndarray:
        b, f = shape[0], shape[1]
        return np.ones((b, f), dtype=bool)


class OpenSoraMaskGenerator(MaskGenerator):
    """OpenSora-style mixed mask modes, drawn per example with the
    configured ratios (the remainder goes to "identity")."""

    VALID = (
        "identity",
        "quarter_random",
        "quarter_head",
        "quarter_tail",
        "quarter_head_tail",
        "image_random",
        "image_head",
        "image_tail",
        "image_head_tail",
        "random",
        "interpolate",
    )

    def __init__(self, mask_ratios: Dict[str, float], **kwargs):
        mask_ratios = dict(mask_ratios)
        assert all(name in self.VALID for name in mask_ratios)
        assert all(0.0 <= r <= 1.0 for r in mask_ratios.values())
        if "identity" not in mask_ratios:
            mask_ratios["identity"] = 1.0 - sum(mask_ratios.values())
        assert math.isclose(sum(mask_ratios.values()), 1.0, abs_tol=1e-6)
        self.mask_ratios = mask_ratios

    def get_masks(self, shape, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        b, f = shape[0], shape[1]
        return np.stack([self._one_mask(f, rng) for _ in range(b)])

    def _one_mask(self, num_frames: int, rng: np.random.Generator) -> np.ndarray:
        mask = np.ones(num_frames, dtype=bool)
        if num_frames <= 1:
            return mask
        u = rng.random()
        acc = 0.0
        name = "identity"
        for mask_name, ratio in self.mask_ratios.items():
            acc += ratio
            if u < acc:
                name = mask_name
                break

        cmax = max(1, num_frames // 4)
        if name == "quarter_random":
            size = int(rng.integers(1, cmax + 1))
            pos = int(rng.integers(0, num_frames - size + 1))
            mask[pos : pos + size] = False
        elif name == "image_random":
            pos = int(rng.integers(0, num_frames))
            mask[pos] = False
        elif name == "quarter_head":
            mask[: int(rng.integers(1, cmax + 1))] = False
        elif name == "image_head":
            mask[:1] = False
        elif name == "quarter_tail":
            mask[-int(rng.integers(1, cmax + 1)) :] = False
        elif name == "image_tail":
            mask[-1:] = False
        elif name == "quarter_head_tail":
            size = int(rng.integers(1, cmax + 1))
            mask[:size] = False
            mask[-size:] = False
        elif name == "image_head_tail":
            mask[:1] = False
            mask[-1:] = False
        elif name == "interpolate":
            start = int(rng.integers(0, 2))
            mask[start::2] = False
        elif name == "random":
            ratio = rng.uniform(0.1, 0.9)
            mask = rng.random(num_frames) > ratio
            if not mask.any():
                mask[-1] = True
        return mask
