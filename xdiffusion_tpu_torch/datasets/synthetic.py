"""Deterministic synthetic digit images (MNIST stand-in for offline envs).

The port's copy of xdiffusion_tpu/datasets/synthetic.py: renders 0-9 from a
5x7 bitmap font with random per-sample shift, scale jitter, and smoothing,
seeded deterministically per split. Same shape contract as MNIST:
(N, 28, 28, 1) float-convertible uint8 + labels. The images and labels
equal the JAX package's bit for bit: the random draws are the same calls in
the same order, and each of the few smoothed glyph shapes is rendered once
and reused instead of once per sample.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 5x7 glyphs, rows top->bottom, '#' = on.
_GLYPHS = {
    0: ["#####", "#...#", "#...#", "#...#", "#...#", "#...#", "#####"],
    1: ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    2: ["#####", "....#", "....#", "#####", "#....", "#....", "#####"],
    3: ["#####", "....#", "....#", ".####", "....#", "....#", "#####"],
    4: ["#...#", "#...#", "#...#", "#####", "....#", "....#", "....#"],
    5: ["#####", "#....", "#....", "#####", "....#", "....#", "#####"],
    6: ["#####", "#....", "#....", "#####", "#...#", "#...#", "#####"],
    7: ["#####", "....#", "...#.", "..#..", "..#..", ".#...", ".#..."],
    8: ["#####", "#...#", "#...#", "#####", "#...#", "#...#", "#####"],
    9: ["#####", "#...#", "#...#", "#####", "....#", "....#", "#####"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array(
        [[1.0 if ch == "#" else 0.0 for ch in row] for row in _GLYPHS[d]],
        dtype=np.float32,
    )


def _smooth(img: np.ndarray) -> np.ndarray:
    """3x3 box blur to soften the bitmap edges (MNIST-ish strokes)."""
    padded = np.pad(img, 1)
    out = np.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = 0.4 if (dy == 0 and dx == 0) else 0.075
            out += w * padded[1 + dy : 1 + dy + img.shape[0],
                              1 + dx : 1 + dx + img.shape[1]]
    return out


def generate_digits(
    num_samples: int, seed: int = 0, image_size: int = 28
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images uint8 (N, S, S, 1), labels int32 (N,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=num_samples).astype(np.int32)
    images = np.zeros((num_samples, image_size, image_size, 1), dtype=np.uint8)
    # Upscale factors are jittered but capped so glyphs fit any canvas
    # (glyph bitmaps are 7 rows x 5 cols).
    fy_hi = max(2, min(4, image_size // 7 + 1))
    fx_hi = max(2, min(4, image_size // 5 + 1))
    shapes = {}
    for i, lab in enumerate(labels):
        fy = int(rng.integers(1, fy_hi))
        fx = int(rng.integers(1, fx_hi))
        key = (int(lab), fy, fx)
        if key not in shapes:
            big = np.kron(_glyph_array(int(lab)), np.ones((fy, fx), dtype=np.float32))
            shapes[key] = _smooth(big)
        big = np.clip(shapes[key] * float(rng.uniform(0.75, 1.0)), 0.0, 1.0)
        big = big[:image_size, :image_size]  # hard cap for tiny canvases
        h, w = big.shape
        max_y = image_size - h
        max_x = image_size - w
        oy = int(rng.integers(0, max(1, max_y)))
        ox = int(rng.integers(0, max(1, max_x)))
        # The canvas is 0 elsewhere and (0 * 255) casts to 0.
        images[i, oy : oy + h, ox : ox + w, 0] = (big * 255).astype(np.uint8)
    return images, labels
