"""FID over the features of a small learned classifier.

Counterpart of xdiffusion_tpu/eval/fid.py. For MNIST-scale data a small
LeNet-style classifier's penultimate features stand in for InceptionV3's:

    fid = |mu_r - mu_g|^2 + Tr(C_r + C_g - 2 (C_r C_g)^{1/2})

`train_feature_extractor` trains the classifier in seconds; `compute_fid`
standardises both feature sets by the real set's per-dimension statistics
(the features are unnormalised, so the raw distance would be set by their
scale) and takes the Frechet distance in float64 numpy and scipy.

The classifier matches the flax module on the same weights: each stride-2
3x3 conv pads as flax's 'SAME' does (at an even size 0 before and 1 after,
which PyTorch's symmetric `padding=1` does not give), and the conv stack's
output is flattened in NHWC order, so the `features` Dense's (2048, 64)
kernel means the same on both sides. It runs on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from xdiffusion_tpu_torch.layers.linear import ConvNHWC, Dense
from xdiffusion_tpu_torch.utils import resolve_device


def _same_size(size: int, stride: int = 2) -> int:
    return -(-size // stride)


def _pad_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """flax 'SAME' padding of an NHWC map for a strided conv: the total
    (out - 1) * stride + kernel - size, the odd element after."""
    pads = []
    for size in (x.shape[2], x.shape[1]):  # F.pad takes the last axis first
        total = max((_same_size(size, stride) - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, (0, 0, *pads))


class FeatureClassifier(nn.Module):
    """LeNet-ish classifier on (B, S, S, C) images in [0, 1]: three stride-2
    3x3 convs with ReLU (32, 64, 128 channels), the `features` Dense to
    `feature_dim`, then ReLU and the `logits` Dense."""

    def __init__(self, in_channels: int = 1, image_size: int = 32, num_classes: int = 10,
                 feature_dim: int = 64):
        super().__init__()
        self.conv1 = ConvNHWC(in_channels, 32, 3, stride=2, dtype=None)
        self.conv2 = ConvNHWC(32, 64, 3, stride=2, dtype=None)
        self.conv3 = ConvNHWC(64, 128, 3, stride=2, dtype=None)
        side = _same_size(_same_size(_same_size(image_size)))
        self.features = Dense(128 * side * side, feature_dim, dtype=None)
        self.logits = Dense(feature_dim, num_classes, dtype=None)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        h = x
        for conv in (self.conv1, self.conv2, self.conv3):
            h = F.relu(conv(_pad_same(h)))
        feats = self.features(h.reshape(h.shape[0], -1))  # NHWC order
        if return_features:
            return feats
        return self.logits(F.relu(feats))


def _init_(model: nn.Module, generator: torch.Generator) -> None:
    """Kernels N(0, 1/fan_in) from `generator`, biases zero."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                draw = torch.randn(p.shape, generator=generator) * p[0].numel() ** -0.5
                p.copy_(draw.to(p.device))


def train_feature_extractor(images: np.ndarray, labels: np.ndarray, steps: int = 500,
                            batch_size: int = 256, seed: int = 0,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Tuple[FeatureClassifier, float]:
    """Supervised training of the classifier on (N, S, S, C) images in
    [0, 1]: Adam at 1e-3, batches drawn with replacement from
    np.random.default_rng(seed) as the JAX package draws them, the weights
    from torch.Generator().manual_seed(seed). Returns (model, last loss)."""
    device = resolve_device(device)
    model = FeatureClassifier(images.shape[-1], images.shape[1])
    _init_(model, torch.Generator().manual_seed(seed))
    model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    host = np.random.default_rng(seed)
    n = images.shape[0]
    loss = None
    for _ in range(steps):
        idx = host.integers(0, n, size=min(batch_size, n))
        x = torch.from_numpy(np.asarray(images[idx], dtype=np.float32)).to(device)
        y = torch.from_numpy(np.asarray(labels[idx], dtype=np.int64)).to(device)
        loss = F.cross_entropy(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    model.eval()
    return model, float(loss.detach())


@torch.no_grad()
def extract_features(model: FeatureClassifier, images: np.ndarray,
                     batch_size: int = 512) -> np.ndarray:
    """(N, feature_dim) float32 features of (N, S, S, C) images in [0, 1],
    computed on the model's device."""
    device = next(model.parameters()).device
    feats = []
    for start in range(0, images.shape[0], batch_size):
        x = torch.from_numpy(np.asarray(images[start:start + batch_size], dtype=np.float32))
        feats.append(model(x.to(device), return_features=True).float().cpu().numpy())
    return np.concatenate(feats)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    from scipy import linalg

    mu_a, mu_b = feats_a.mean(axis=0), feats_b.mean(axis=0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    # sqrtm's `disp` flag, which the JAX package passes, is gone from newer
    # SciPy; without it every version returns the root alone.
    covmean = linalg.sqrtm(cov_a @ cov_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a + cov_b - 2.0 * covmean))


def compute_fid(real_images: np.ndarray, generated_images: np.ndarray,
                labels: Optional[np.ndarray] = None,
                extractor: Optional[FeatureClassifier] = None, classifier_steps: int = 500,
                device: Optional[Union[str, torch.device]] = None) -> float:
    """FID between two sets of [0, 1] images; trains the extractor on the
    real set and `labels` unless one is given."""
    if extractor is None:
        if labels is None:
            raise ValueError("compute_fid: labels are needed to train the extractor")
        extractor, _ = train_feature_extractor(real_images, labels, steps=classifier_steps,
                                               device=device)
    fa = extract_features(extractor, real_images)
    fb = extract_features(extractor, generated_images)
    # Standardise both by the real set's statistics: then the real-against-
    # real floor is near 0.
    mu, sigma = fa.mean(axis=0), fa.std(axis=0) + 1e-6
    return frechet_distance((fa - mu) / sigma, (fb - mu) / sigma)
