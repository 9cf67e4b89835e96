"""MNIST with precomputed Gemma-2 prompt embeddings.

Counterpart of xdiffusion_tpu/datasets/mnist_embedded_gemma_2.py: MNIST
images (datasets/mnist.py) and, per digit and surface form ("zero" or
"0"), a (300, 2304) Gemma-2 embedding of the prompt. They come from
{data_root}/mnist_gemma2/embeddings.npz when that file exists (key
"embeddings", (10, 2, 300, 2304), [digit][surface form]; written by a tool
that needs Gemma-2's weights), else from the deterministic hash embedding
of each prompt, bit-equal to the JAX package's. They are kept per prompt
(20 of them, not 60,000) and gathered at batch time.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from xdiffusion_tpu_torch.datasets.mnist import _TEXT_FORMS, MNIST, data_root
from xdiffusion_tpu_torch.datasets.mnist import convert_labels_to_prompts  # noqa: F401

EMBEDDING_TOKENS = 300
EMBEDDING_DIM = 2304


def _hash_embedding(text: str) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(text.encode("utf-8")).digest()[:8], "little")
    v = np.random.default_rng(seed).normal(
        size=(EMBEDDING_TOKENS, EMBEDDING_DIM)).astype(np.float32)
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)


class MNISTEmbeddedGemma2(MNIST):
    """MNIST images and labels, and `prompt_embeddings` (10, 2, 300, 2304)
    fp32; `synthetic_embeddings` tells whether they are the hash stand-in."""

    def __init__(self, split: str = "train", image_size: int = 32, **kwargs):
        super().__init__(split=split, image_size=image_size, **kwargs)
        path = os.path.join(data_root(), "mnist_gemma2", "embeddings.npz")
        if os.path.exists(path):
            with np.load(path) as data:
                self.prompt_embeddings = data["embeddings"].astype(np.float32)
            self.synthetic_embeddings = False
        else:
            self.prompt_embeddings = np.stack(
                [np.stack([_hash_embedding(form) for form in forms]) for forms in _TEXT_FORMS])
            self.synthetic_embeddings = True

    def embeddings_for(self, labels: np.ndarray,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(B,) labels -> (B, 300, 2304) embeddings, each of a surface form
        drawn from `rng` (unseeded without one, as in the JAX package)."""
        rng = rng or np.random.default_rng()
        picks = rng.integers(0, self.prompt_embeddings.shape[1], size=len(labels))
        return self.prompt_embeddings[np.asarray(labels), picks]
